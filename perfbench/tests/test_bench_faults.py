"""A run with its timed path broken underneath reads ``correct`` false:
once for each fault a serving cell can have (``yardstick/faults.py``).
At a tiny size on the CPU, past the look for a card; each fault is
planted in the program for the test only (``monkeypatch``)."""

import pytest
from yardstick.cell import passed
from yardstick.faults import CELL_FAULTS, plant

from test_bench_cells import tiny_run


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c, fs in CELL_FAULTS.items() for f in fs])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    plant(fault, monkeypatch.setattr)
    _, out = tiny_run(cell, 2 ** 31 + 5, False,
                      5.0 if "longdoc" in cell else 3.0)
    assert out["checks"]["sampled_tokens"]["value"] > 0
    assert not passed(out["checks"]), out["checks"]
