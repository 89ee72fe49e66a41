"""The port's examples (``examples/torch/{quickstart,pointcloud,
isax_matching_demo}.py``) on the CPU, held to the reference's.

Each runs as a user would, in a subprocess where ``jax`` and ``repro``
cannot be imported, and prints its OK line.  In this process, against
the JAX package: the matching demo's five rows (rewrites, e-nodes before
and after saturation, the match, and the offloaded program equal to the
plain loop) against the reference's ``compile_program`` of the same
variants; the quickstart's fir7 schedule (cycles and decisions) against
``repro.core.synthesis.synthesize`` and its attention compile against the
reference's; the point-cloud example's three match stats against the
reference's, and its ``--smoke`` stage's indices exactly (and the
max-pool) against the reference's set abstraction on backend
``pallas_interpret``, on the same numpy inputs.  Compile counters depend
on the string hash seed, so both sides compile in one process.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.compile import Dispatcher as JDispatcher
from repro.compile import LoweringConfig as JLowering
from repro.compile.trace import trace_term as jtrace_term
from repro.core import aquas_ir as jir
from repro.core.offload import compile_program as jcompile
from repro.core.offload import evaluate as jevaluate
from repro.core.synthesis import synthesize as jsynthesize
from repro.core.interface_model import (
    paper_example_interfaces as jinterfaces)
from repro.targets import isax_library as jlibrary
from repro.targets.llm import isax_int8_matvec as jisax_int8_matvec
from repro_torch.core import offload

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _load("quickstart")
pointcloud = _load("pointcloud")
matching = _load("isax_matching_demo")


@pytest.fixture(autouse=True)
def _own_intrinsics(monkeypatch):
    """The examples register their intrinsics process-wide: keep them out
    of the tests that run after these in the same process."""
    monkeypatch.setattr(offload, "_INTRINSICS", dict(offload._INTRINSICS))


@pytest.mark.parametrize("script,args,ok", [
    ("quickstart.py", ["--smoke", "--device", "cpu"], "quickstart OK"),
    ("pointcloud.py", ["--smoke", "--device", "cpu"], "pointcloud example OK"),
    ("isax_matching_demo.py", ["--device", "cpu"],
     "isax matching demo OK (cpu)")])
def test_example_runs_without_jax(tmp_path, script, args, ok):
    (tmp_path / "jax.py").write_text("raise ImportError('no jax here')\n")
    (tmp_path / "repro.py").write_text("raise ImportError('no repro here')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / script), *args],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert ok in out.stdout


def test_examples_raise_without_a_card(monkeypatch):
    """The default device is the card: with none visible each example
    raises before it computes anything."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for mod in (quickstart, pointcloud, matching):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def _copy(env: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in env.items()}


def test_matching_demo_rows_equal_the_reference():
    rows = matching.rows("cpu")
    ix = jisax_int8_matvec()
    rng = np.random.default_rng(0)
    base = dict(Wq=rng.integers(-127, 127, size=(5, 7)).astype(np.int8),
                X=rng.normal(size=(8, 7)), s_w=0.02, n=8, C=np.zeros((8, 5)))
    plain = _copy(base)
    jevaluate(matching.VARIANTS["plain"], plain)
    assert [r["variant"] for r in rows] == list(matching.VARIANTS)
    for row, (name, sw) in zip(rows, matching.VARIANTS.items()):
        s = jcompile(sw, [ix], case=name).stats
        env = _copy(base)
        jevaluate(jcompile(sw, [ix], case=name).program, env)
        want = dict(variant=name, internal=s.internal_rewrites,
                    external=s.external_rewrites,
                    enodes=[s.initial_enodes, s.saturated_enodes],
                    matched="int8_matvec" in s.matched_isaxes,
                    allclose=bool(np.allclose(env["C"], plain["C"],
                                              atol=1e-6)))
        assert row == want
        assert row["matched"] and row["allclose"]


def _jfir7():
    return jir.FunctionalProgram("fir7", [
        jir.FuncOp("transfer", "src", 108, jir.Space.GLOBAL,
                   jir.Space.SCRATCHPAD, "load", jir.CacheHint.COLD),
        jir.FuncOp("transfer", "bias", 28, jir.Space.GLOBAL,
                   jir.Space.SCRATCHPAD, "load", jir.CacheHint.WARM,
                   scratchpad="bias")],
        {"bias": jir.ScratchpadDecl("bias", 28, jir.CacheHint.WARM,
                                    compute_cycles_per_elem=8.0)})


def test_quickstart_synthesis_and_compile_equal_the_reference():
    hw = quickstart.hardware_side()
    want = jsynthesize(_jfir7(), jinterfaces())
    assert hw["fir7_cycles"] == want.total_cycles
    assert hw["fir7_decisions"] == want.decisions
    for label, _, _, _ in quickstart.FLASH_SHAPES:
        pick = hw["flash"][label]
        assert pick["kernel"] in ("flash_attention",
                                  "flash_attention_pipelined")
        assert pick["predicted_us"] > 0
    sw = quickstart.software_side("cpu")
    s = jcompile(quickstart.attention_program(), jlibrary(),
                 case="quickstart").stats
    assert sw == {"matched": list(s.matched_isaxes),
                  "internal": s.internal_rewrites,
                  "external": s.external_rewrites,
                  "enodes": [s.initial_enodes, s.saturated_enodes],
                  "offloaded_equal": True}


def test_pointcloud_match_stats_and_smoke_stage_equal_the_reference():
    got = pointcloud.software_side("cpu")
    assert got["fps_equal"]
    for kind, stats in got["match"].items():
        s = jcompile(jtrace_term(kind), jlibrary(), case=kind).stats
        assert stats == dict(matched=list(s.matched_isaxes),
                             internal=s.internal_rewrites,
                             enodes=[s.initial_enodes, s.saturated_enodes])

    stage = pointcloud.system_side(pointcloud.resolve_device("cpu"),
                                   smoke=True)
    assert all(stage["checks"].values())
    xyz_np, feats_np, M, K, r = pointcloud.stage_inputs(smoke=True)
    xyz, feats = jnp.asarray(xyz_np), jnp.asarray(feats_np)
    lw = JLowering.from_registry("pallas_interpret",
                                 dispatcher=JDispatcher())
    sel = lw.fps(xyz, M)
    centers = jnp.take_along_axis(xyz, sel[..., None], axis=1)
    idx = lw.ball_query(xyz, centers, r, K)
    agg = lw.group_aggregate(feats, idx)
    got_sel, got_idx = stage["indices"]
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(stage["aggregate"].numpy(),
                                  np.asarray(agg))
    assert {op: rec["impl"] for op, rec in stage["records"].items()} == {
        "fps": "isax", "ball_query": "isax", "group_aggregate": "isax"}
