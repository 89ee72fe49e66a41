"""The control, kept at a size a CPU test holds: the plain reference at
fp8 in the program's place.  Its tokens, judged by the fp32 reference as
a run judges the program's, fail the cell's limit on every seed, and so
do its K and V where the cell checks the KV cache, while the fp32
reference's own read 0.  (On the card, at each cell's
own size, ``perfbench/control.py`` reads it; PERF.md gives the
readings.)"""

import importlib
import json

import numpy as np
import pytest
import torch
from conftest import ROOT
from yardstick import check, weights
from yardstick.cell import REFERENCES

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

#: Narrower and shallower than the configurations, yet deep enough that
#: fp8's rounding moves the logits as it does at full size (PERF.md).
SMALL = {
    "granite-3-8b": {"family": "dense", "n_layers": 4, "d_model": 512,
                     "n_heads": 4, "n_kv_heads": 1, "head_dim": 128,
                     "d_ff": 1600, "vocab": 6144, "rope_theta": 10000.0,
                     "tie_embeddings": True, "norm_eps": 1e-5,
                     "param_dtype": "float32"},
    "mamba2-2.7b": {"family": "ssm", "n_layers": 16, "d_model": 320,
                    "vocab": 6285, "norm_eps": 1e-5, "tie_embeddings": True,
                    "ssm": {"d_state": 128, "head_dim": 64, "expand": 2,
                            "conv_width": 4},
                    "param_dtype": "float32"},
}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_control_fails_the_limit(cell, seed):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    limit = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json")
                       .read_text())["check"]["logit_gap_limit"]
    m = SMALL[entry["config"]]
    ref = importlib.import_module(REFERENCES[m["family"]])
    params = weights.draw(m, seed, "cpu")
    rng = np.random.default_rng(seed)
    seqs = [torch.as_tensor(rng.integers(0, m["vocab"], 96))
            for _ in range(4)]
    wanted = [list(range(32, 96))] * 4
    want = ref.logits_at(params, m, seqs, wanted)
    low = ref.logits_at(params, m, seqs, wanted, quant="fp8")
    assert check.control_gap(want, low) > limit
    assert check.widest_gap(want, [w.argmax(-1) for w in want]) == 0.0
    kv_limit = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json")
                          .read_text())["check"].get("kv_error_limit")
    if kv_limit is not None:
        ref_kv = ref.kv_at(params, m, seqs)
        assert check.kv_error(ref_kv, ref.kv_at(params, m, seqs, "fp8"),
                              [32] * 4) > kv_limit
        assert check.kv_error(ref_kv, ref_kv, [32] * 4) == 0.0
