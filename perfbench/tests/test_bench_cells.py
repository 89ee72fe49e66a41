"""Each cell's path at a tiny size on the CPU, below the look for a card:
a valid result line, every number the check compares in it, last; and
the command-line entry refusing to run without a card."""

import json
import time

import pytest
from conftest import ROOT, TINY
from yardstick.cell import HERE, load_spec, run_cell

import run as bench_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_run(cell, seed, trace=False, seconds=2.0):
    spec = load_spec(BENCH, cell)
    if "ramp_s" in spec.cell:
        spec.cell["ramp_s"] = 1.0
        # fewer slots: a CPU decode step gathers every slot's whole range
        e = spec.cell["engine"]
        e["max_batch"] = 8
        if e["max_len"] > 2048:
            # a CPU prefill of 2-4k tokens takes most of a second, longer
            # than the gap between arrivals: prompts and buckets an eighth
            # as long, room for the answers kept
            e["prompt_buckets"] = [b // 8 for b in e["prompt_buckets"]]
            e["max_len"] = e["max_len"] // 8 + 64
            d = spec.mix["prompt_len"]
            spec.mix["prompt_len"] = dict(d, min=d["min"] // 8,
                                          max=d["max"] // 8)
    out = run_cell(spec, seed, seconds, trace, time.perf_counter(),
                   device="cpu", model=TINY[spec.config["port"]["family"]])
    return spec, out


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_a_valid_line(cell, trace):
    # a closed batch of 16 x 2040 takes about a second on the CPU
    spec, out = tiny_run(cell, 2 ** 31 + 77, trace,
                         5.0 if "longdoc" in cell else 2.0)
    line = json.loads(json.dumps(bench_run.result_line(spec, out, trace,
                                                       "cpu")))
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"]: m["unit"]
            for m in (spec.per_layer if trace else spec.end_to_end)}
    assert set(line["metrics"]) <= set(want)
    for name, v in line["metrics"].items():
        assert v["unit"] == want[name] and v["value"] == v["value"]
    if not trace:
        assert set(line["metrics"]) == set(want)   # every end-to-end metric
    else:
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(capsys):
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_every_cell_and_metric_has_its_files():
    for w in BENCH["workloads"]:
        for part, name in (("workloads", w["name"]),
                           ("traffic", w["traffic"])):
            assert (HERE / part / f"{name}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
