"""The plain fp32 references held to ``repro_torch`` on backend ``torch``
at a tiny size on the CPU: prefill logits at several lengths, and logits
decoded through the port's caches (KV cache, SSM conv and state) after
it.  This test imports the port; the references themselves do not."""

import importlib

import numpy as np
import pytest
import torch
from conftest import TINY
from repro_torch.compile.config import LoweringConfig
from repro_torch.models.registry import get_model
from yardstick import weights
from yardstick.cell import REFERENCES, model_config

#: fp32 on both sides; sums in another order leave ~1e-6 on logits ~1
ATOL = 1e-4


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_reference_matches_the_port(family):
    m = TINY[family]
    ref = importlib.import_module(REFERENCES[family])
    params = weights.draw(m, 2 ** 32 + 3, "cpu")
    model = get_model(model_config(m), lowering=LoweringConfig("torch"))
    toks = np.random.default_rng(0).integers(0, m["vocab"], 40)
    seq = torch.as_tensor(toks)
    n0 = 29
    want = ref.logits_at(params, m, [seq], [list(range(n0 - 1, 40))])[0]
    with torch.no_grad():
        for n in (1, 7, n0):
            got, _ = model.prefill(params, {"tokens": seq[None, :n]})
            assert torch.allclose(got[0], ref.logits_at(
                params, m, [seq[:n]], [[n - 1]])[0][0], atol=ATOL)
        logits, caches = model.prefill(params, {"tokens": seq[None, :n0]},
                                       64)
        rows = [logits[0]]
        for pos in range(n0, 40):
            logits, caches = model.decode_step(params, seq[pos:pos + 1],
                                               caches, pos)
            rows.append(logits[0])
    assert torch.allclose(torch.stack(rows), want, atol=ATOL)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_control_changes_the_logits(family):
    """fp8 operands move the logits by far more than fp32 rounding."""
    m = TINY[family]
    ref = importlib.import_module(REFERENCES[family])
    params = weights.draw(m, 5, "cpu")
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, 512, 33))
    a = ref.logits_at(params, m, [seq], [list(range(33))])[0]
    b = ref.logits_at(params, m, [seq], [list(range(33))], quant="fp8")[0]
    assert float((a - b).abs().max()) > 100 * ATOL
