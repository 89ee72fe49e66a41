"""The port's lowering table against the reference's dispatcher, the
port's independence from JAX, and its refusal to fall back to the CPU."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import repro.compile as jax_compile
from repro_torch.compile.config import LoweringConfig, lower
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# (op, shape) keys of the main path at llama110m's widths (12 heads of 64,
# d 768, d_ff 2048) and of its reduced test config (4 heads of 16, d 64).
MAIN_PATH_KEYS = [
    ("rmsnorm", (16, 768)), ("rmsnorm", (512, 768)), ("rmsnorm", (8, 768)),
    ("rmsnorm", (16, 64)),
    *[("attention", (1, s, 12, 12, s, 64)) for s in (16, 32, 64, 128, 256, 512)],
    ("attention", (1, 16, 4, 4, 16, 16)),
    ("attention", (1, 4, 12, 12, 4, 64)),              # S < 8
    ("attention_paged", (8, 1, 12, 12, 544, 64)),
    ("attention_paged", (2, 1, 4, 4, 64, 16)),
    ("attention_decode", (4, 1, 12, 12, 72, 64)),
    ("matmul", (16, 768, 2048)), ("matmul", (8, 768, 32000)),
]


@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas"),
                                                 ("torch", "xla")])
@pytest.mark.parametrize("op,shape", MAIN_PATH_KEYS)
def test_routing_table_matches_reference_dispatch(op, shape, backend,
                                                  ref_backend):
    want = jax_compile.lower(op, shape=shape, dtype="float32",
                             backend=ref_backend).impl
    assert lower(op, shape=shape, dtype=torch.float32,
                 backend=backend).impl == want


# Point-cloud keys: golden keys 8-10 (tests/golden/dispatch_records.json),
# the untileable shape of tests/test_pointcloud.py:150, S > N, and the
# bench's and PointNet++ SA1's sizes.
GOLDEN = json.loads((ROOT / "tests/golden/dispatch_records.json").read_text())
POINTCLOUD_KEYS = [
    *[(r["op"], tuple(r["shape"])) for r in GOLDEN[8:11]],
    ("ball_query", (1, 200, 65, 8)), ("group_aggregate", (1, 200, 65, 8, 32)),
    ("fps", (1, 200, 300)), ("fps", (2, 256, 256)),
    ("fps", (2, 4096, 512)), ("ball_query", (2, 4096, 512, 16)),
    ("group_aggregate", (2, 4096, 512, 16, 64)),
    ("fps", (16, 1024, 512)), ("ball_query", (16, 1024, 512, 32)),
    ("group_aggregate", (16, 1024, 512, 32, 64)),
]


@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas"),
                                                 ("torch", "xla")])
@pytest.mark.parametrize("op,shape", POINTCLOUD_KEYS)
def test_pointcloud_routing_matches_reference_dispatch(op, shape, backend,
                                                       ref_backend):
    want = jax_compile.lower(op, shape=shape, dtype="float32",
                             backend=ref_backend)
    got = lower(op, shape=shape, dtype=torch.float32, backend=backend)
    assert got.impl == want.impl, (got.note, want.note)


def test_pointcloud_golden_keys_extract_the_kernel():
    for rec in GOLDEN[8:11]:
        got = lower(rec["op"], shape=rec["shape"], dtype=torch.float32)
        assert got.impl == rec["impl"] == "isax"
        assert rec["target"] in got.note
    assert lower("fps", shape=(1, 200, 300), dtype=torch.float32).impl \
        == "reference"
    for op, shape in (("ball_query", (1, 200, 65, 8)),
                      ("group_aggregate", (1, 200, 65, 8, 32))):
        got = lower(op, shape=shape, dtype=torch.float32)
        assert got.impl == "reference" and "untileable" in got.note


# SSD scan keys (b, s, H, P, N): mamba2-2.7b's widths at the serving
# prompts (512: the pipelined kernel; 40: one chunk), the reference's
# ragged S=100 (chunk 4) and S=1, and the reduced config's widths.
SSD_KEYS = [(1, 512, 80, 64, 128), (4, 512, 80, 64, 128),
            (4, 256, 80, 64, 128), (1, 100, 80, 64, 128), (1, 1, 80, 64, 128),
            (4, 40, 80, 64, 128), (2, 20, 16, 8, 16), (2, 1, 16, 8, 16)]


@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas"),
                                                 ("torch", "xla")])
@pytest.mark.parametrize("shape", SSD_KEYS)
def test_ssd_routing_matches_reference_dispatch(shape, backend, ref_backend):
    want = jax_compile.lower("ssd_scan", shape=shape, dtype="float32",
                             backend=ref_backend)
    got = lower("ssd_scan", shape=shape, dtype=torch.float32, backend=backend)
    assert got.impl == want.impl, got.note


# Keys where the port's lowering once said "reference" while the
# reference's said "isax" (fp16 everywhere; head dims 80, 96, 256 with one
# KV head; SSD in bf16/fp16, at P = 6 and at N = 256), and neighbours that
# were right already.
FAULT1_KEYS = [
    ("rmsnorm", (512, 768)), ("attention", (1, 64, 12, 12, 64, 64)),
    ("attention", (1, 64, 12, 12, 64, 80)),
    ("attention", (1, 64, 12, 12, 64, 96)),
    ("attention", (1, 64, 8, 1, 64, 256)),
    ("attention", (1, 64, 12, 12, 64, 128)),
    ("ssd_scan", (1, 512, 80, 64, 128)), ("ssd_scan", (1, 8, 2, 6, 128)),
    ("ssd_scan", (1, 8, 2, 64, 256)), ("ssd_scan", (1, 8, 2, 64, 64)),
    ("fps", (2, 4096, 512)), ("ball_query", (2, 4096, 512, 16)),
    ("group_aggregate", (2, 4096, 512, 16, 64)),
    ("int8_matmul", (8, 768, 768)),
]
ALL_KEYS = (FAULT1_KEYS + MAIN_PATH_KEYS + POINTCLOUD_KEYS
            + [("ssd_scan", s) for s in SSD_KEYS])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op,shape", ALL_KEYS)
def test_lowering_matches_reference_in_every_dtype(op, shape, dtype):
    """The port's ``impl`` on backend cuda is the reference's on backend
    pallas, for every key set and every dtype the reference's kernels take."""
    want = jax_compile.lower(op, shape=shape, dtype=dtype, backend="pallas")
    got = lower(op, shape=shape, dtype=getattr(torch, dtype))
    assert got.impl == want.impl, (got.note, want.note)


@pytest.mark.parametrize("op,shape,note", [
    ("attention", (1, 64, 8, 1, 64, 320), "head dim 320 > 256"),
    ("ssd_scan", (1, 8, 2, 256, 256), "does not fit"),
])
def test_lowering_states_its_deviations(op, shape, note):
    """Where the port's kernels stop short of the reference's (a head dim
    above 256, an SSD state that does not fit one block), ``lower`` says
    ``reference`` and why."""
    got = lower(op, shape=shape, dtype=torch.float32)
    assert got.impl == "reference" and note in got.note


def test_unknown_op_and_backend_raise():
    with pytest.raises(ValueError):
        LoweringConfig("pallas")
    with pytest.raises(ValueError):
        lower("conv2d", shape=(1, 1, 1), dtype=torch.float32)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_runs_with_jax_and_repro_unimportable(tmp_path):
    """A fresh interpreter in which ``import jax`` and ``import repro`` fail
    still imports every module of the port and serves on the CPU."""
    (tmp_path / "jax.py").write_text("raise ImportError('no jax here')\n")
    (tmp_path / "repro.py").write_text("raise ImportError('no repro here')\n")
    code = (
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.launch.serve import main\n"
        "main(['--arch', 'llama110m', '--smoke', '--continuous', "
        "'--device', 'cpu', '--requests', '3', '--tokens', '4'])\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "requests=3" in out.stdout


def test_engines_raise_without_cuda_when_no_device_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engines run on it")
    from repro_torch.launch.serve import main
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine
    cfg = reduced(get_config("llama110m"))
    for ctor in (ContinuousEngine, ServeEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "llama110m", "--smoke", "--continuous"])


def test_kernel_wrappers_refuse_non_cuda_devices():
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = torch.ones((2, 8), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(8, device="meta"))


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result line where there
    is no card, both in the repo and copied into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
