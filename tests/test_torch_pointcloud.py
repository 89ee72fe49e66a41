"""The port's point-cloud path (``repro_torch.pointcloud``) against the JAX
package on the CPU: the plain versions against ``repro.pointcloud.ref``,
the port's routing wrappers against the Pallas kernels in interpret mode,
and the whole set-abstraction stage through both ``LoweringConfig``s.

Index outputs must match exactly (``repro/pointcloud/ref.py``), and so must
the max-pool against ``group_aggregate_ref``, since it only selects values;
against the one-hot Pallas gather the reference's own test allows 1e-6
(``tests/test_pointcloud.py:143``).
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import Dispatcher
from repro.compile import LoweringConfig as JaxLoweringConfig
from repro.pointcloud import kernels as jax_pck
from repro.pointcloud import ops as jax_pcops
from repro.pointcloud import ref as jax_ref
from repro_torch.compile.config import LoweringConfig
from repro_torch.kernels import pipeline
from repro_torch.launch.pointcloud import set_abstraction
from repro_torch.pointcloud import kernels as pck
from repro_torch.pointcloud import ops as pc_ops
from repro_torch.pointcloud import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N, M, K, C = 2, 256, 64, 8, 32
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _cloud(kind: str, dtype: str):
    """(xyz, centers, features, radius) as torch tensors of ``dtype``.

    * ``normal``: points and features normal(0, 1), centers the first M
      points, r = 0.9 (the reference's test);
    * ``lattice``: integer points in [0, 6)³ with repeats, so FPS meets
      exact ties and many d² land exactly on r² = 1;
    * ``empty``: centers scattered three times wider than the cloud with
      r = 0.3, so many balls are empty and take their nearest point.
    """
    rng = np.random.default_rng({"normal": 0, "lattice": 1, "empty": 2}[kind])
    if kind == "lattice":
        xyz = rng.integers(0, 6, size=(B, N, 3)).astype(np.float32)
        centers, radius = xyz[:, :M], 1.0
    elif kind == "empty":
        xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
        centers = 3.0 * rng.normal(size=(B, M, 3)).astype(np.float32)
        radius = 0.3
    else:
        xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
        centers, radius = xyz[:, :M], 0.9
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    tdt = DTYPES[dtype][0]
    return (torch.from_numpy(xyz).to(tdt), torch.from_numpy(centers).to(tdt),
            torch.from_numpy(feats).to(tdt), radius)


def _jax(t: torch.Tensor, dtype: str):
    """The same values in JAX (exact: bf16 and fp16 go through fp32)."""
    return jnp.asarray(t.float().numpy(), DTYPES[dtype][1])


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _t(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy() if x.is_floating_point() else x.numpy()


CLOUDS = ["normal", "lattice", "empty"]


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", CLOUDS)
def test_fps_ref_matches_jax(kind, dtype):
    xyz, _, _, _ = _cloud(kind, dtype)
    want = jax_ref.fps_ref(_jax(xyz, dtype), M)
    np.testing.assert_array_equal(_t(ref.fps_ref(xyz, M)), _np(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", CLOUDS)
def test_ball_query_ref_matches_jax(kind, dtype):
    xyz, centers, _, radius = _cloud(kind, dtype)
    want = jax_ref.ball_query_ref(_jax(xyz, dtype), _jax(centers, dtype),
                                  radius, K)
    got = ref.ball_query_ref(xyz, centers, radius, K)
    np.testing.assert_array_equal(_t(got), _np(want))
    d2 = ref.sqdist(centers[:, :, None], xyz[:, None])
    hits = (d2 <= radius * radius).sum(-1)
    if kind == "empty":
        assert (hits == 0).any() and (hits > 0).any()
    if kind == "lattice":
        assert (d2 == 1.0).any() and (hits > K).any() and (hits < K).any()


@pytest.mark.parametrize("radius_sq", [1.0, 2.0, 3.0])
def test_ball_query_ref_radius_sq_matches_jax(radius_sq):
    xyz, centers, _, _ = _cloud("lattice", "float32")
    radius = float(np.sqrt(radius_sq))
    want = jax_ref.ball_query_ref(_jax(xyz, "float32"),
                                  _jax(centers, "float32"), radius, K,
                                  radius_sq=radius_sq)
    got = ref.ball_query_ref(xyz, centers, radius, K, radius_sq=radius_sq)
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", CLOUDS)
def test_group_aggregate_ref_matches_jax(kind, dtype):
    xyz, centers, feats, radius = _cloud(kind, dtype)
    idx = ref.ball_query_ref(xyz, centers, radius, K)
    want = jax_ref.group_aggregate_ref(_jax(feats, dtype),
                                       jnp.asarray(idx.numpy()))
    got = ref.group_aggregate_ref(feats, idx)
    assert got.dtype == feats.dtype and got.shape == (B, M, C)
    np.testing.assert_array_equal(_t(got), _np(want))


def test_group_aggregate_ref_takes_indices_as_the_jax_gather_does():
    feats = torch.arange(5.0)[None, :, None].repeat(1, 1, 2)
    idx = torch.tensor([[[-1, -6], [7, 2], [-5, 0]]], dtype=torch.int32)
    want = jax_ref.group_aggregate_ref(jnp.asarray(feats.numpy()),
                                       jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(_t(ref.group_aggregate_ref(feats, idx)),
                                  np.asarray(want))


@pytest.mark.parametrize("order", [(0, 1, 2), (1, 2, 0), (2, 0, 1)])
def test_sqdist_sums_left_to_right_as_jax(order):
    """Squares 1, 2^-24, 2^-24 sum to 1 left to right but not pairwise, so
    the order of the sum shows; the CUDA kernels use the same order."""
    d = np.array([1.0, 2.0 ** -12, 2.0 ** -12], np.float32)[list(order)]
    a, b = np.zeros((1, 3), np.float32), d[None]
    want = jnp.sum((jnp.asarray(b) - jnp.asarray(a)) ** 2, -1)
    got = ref.sqdist(torch.from_numpy(b), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_squared_radius_is_the_fp32_product():
    r = 0.9
    assert ref.squared_radius(r) == float(np.float32(r) * np.float32(r))
    assert ref.squared_radius(r) != r * r
    assert ref.squared_radius(r, radius_sq=0.81) == float(np.float32(0.81))


# ---------------------------------------------------------------------------
# The port's routing wrappers against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "lattice"])
def test_fps_matches_pallas_interpret(kind, dtype):
    xyz, _, _, _ = _cloud(kind, dtype)
    want = jax_pck.fps(_jax(xyz, dtype), M, interpret=True)
    got = pc_ops.farthest_point_sample(xyz, M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", CLOUDS)
def test_ball_query_matches_pallas_interpret(kind, dtype, pipelined):
    xyz, centers, _, radius = _cloud(kind, dtype)
    jx, jc = _jax(xyz, dtype), _jax(centers, dtype)
    if pipelined:   # four streamed X tiles through a depth-3 ring
        want = jax_pck.ball_query_pipelined(jx, jc, radius, K, block_n=64,
                                            depth=3, interpret=True)
    else:
        want = jax_pck.ball_query(jx, jc, radius, K, interpret=True)
    got = pc_ops.ball_query(xyz, centers, radius, K, pipelined=pipelined)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "empty"])
def test_group_aggregate_matches_pallas_interpret(kind, dtype, pipelined):
    xyz, centers, feats, radius = _cloud(kind, dtype)
    idx = pc_ops.ball_query(xyz, centers, radius, K)
    jf, ji = _jax(feats, dtype), jnp.asarray(idx.numpy())
    if pipelined:
        pallas = jax_pck.group_aggregate_pipelined(jf, ji, block_n=64,
                                                   depth=3, interpret=True)
    else:
        pallas = jax_pck.group_aggregate(jf, ji, interpret=True)
    got = pc_ops.group_aggregate(feats, idx, pipelined=pipelined)
    assert got.dtype == feats.dtype
    np.testing.assert_array_equal(
        _t(got), _np(jax_ref.group_aggregate_ref(jf, ji)))
    np.testing.assert_allclose(_t(got), _np(pallas), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The set-abstraction stage through LoweringConfig, both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [None, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_stage_matches_jax_lowering_config(backend, dtype, pipelined):
    xyz, _, feats, radius = _cloud("normal", dtype)
    jlw = JaxLoweringConfig("pallas_interpret", Dispatcher())
    jx, jf = _jax(xyz, dtype), _jax(feats, dtype)
    jsel = jlw.fps(jx, M)
    jcen = jnp.take_along_axis(jx, jsel[..., None], axis=1)
    jidx = jlw.ball_query(jx, jcen, radius, K)
    jagg = jlw.group_aggregate(jf, jidx)

    sel, centers, idx, agg = set_abstraction(
        LoweringConfig(backend), xyz, feats, M, radius, K,
        pipelined=pipelined)
    np.testing.assert_array_equal(_t(sel), _np(jsel))
    np.testing.assert_array_equal(_t(centers), _np(jcen))
    np.testing.assert_array_equal(_t(idx), _np(jidx))
    np.testing.assert_array_equal(
        _t(agg), _np(jax_ref.group_aggregate_ref(jf, jidx)))
    np.testing.assert_allclose(_t(agg), _np(jagg), atol=1e-6, rtol=0)


def test_stage_falls_back_where_the_reference_does():
    """The untileable shape of tests/test_pointcloud.py:150 and S > N."""
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.normal(size=(1, 200, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(1, 200, C)).astype(np.float32))
    lw = LoweringConfig("cuda")
    jx = jnp.asarray(xyz.numpy())
    centers = xyz[:, :65]
    idx = lw.ball_query(xyz, centers, 0.9, K)
    np.testing.assert_array_equal(
        _t(idx), np.asarray(jax_pcops.ball_query(jx, jx[:, :65], 0.9, K,
                                                 interpret=True)))
    agg = lw.group_aggregate(feats, idx)
    np.testing.assert_array_equal(
        _t(agg), np.asarray(jax_ref.group_aggregate_ref(
            jnp.asarray(feats.numpy()), jnp.asarray(idx.numpy()))))
    sel = lw.fps(xyz, 300)    # more samples than points: the plain version
    np.testing.assert_array_equal(
        _t(sel), np.asarray(jax_pcops.farthest_point_sample(jx, 300,
                                                            interpret=True)))


# ---------------------------------------------------------------------------
# Routing and the wrappers' contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Mc", [4, 6, 8, 12, 16, 64, 65, 512])
@pytest.mark.parametrize("Np", [64, 96, 128, 200, 256, 384, 1024, 4096])
def test_tileable_is_the_reference_tiling_test(Mc, Np):
    for sched, key in ((jax_pcops._ball_schedule(Mc, Np, K, 4), "x"),
                       (jax_pcops._group_schedule(Mc, Np, K, C, 4), "f")):
        want = jax_pcops.pc_tiles(Mc, Np, sched, key) is not None
        assert pc_ops.tileable(Mc, Np) == want


def _record_calls(monkeypatch):
    calls = []
    for name in ("fps", "ball_query", "ball_query_pipelined",
                 "group_aggregate", "group_aggregate_pipelined"):
        real = getattr(pck, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, kw.get("depth")))
            return _real(*args, **kw)
        monkeypatch.setattr(pck, name, spy)
    return calls


@pytest.mark.parametrize("Np,pipelined,want", [
    (256, None, ("ball_query", None)),           # one X tile
    (512, None, ("ball_query_pipelined", 2)),
    (1024, None, ("ball_query_pipelined", 4)),
    (4096, None, ("ball_query_pipelined", 4)),
    (4096, False, ("ball_query", None)),
    (256, True, ("ball_query", None)),           # one tile never pipelines
])
def test_ball_query_routes_by_streamed_tiles(monkeypatch, Np, pipelined, want):
    calls = _record_calls(monkeypatch)
    xyz = torch.zeros((1, Np, 3))
    pc_ops.ball_query(xyz, xyz[:, :8], 0.5, 4, pipelined=pipelined)
    assert calls == [want]


@pytest.mark.parametrize("Np,k,Cc,dtype,pipelined,want", [
    (256, 16, 64, torch.float32, None, ("group_aggregate", None)),  # 1 tile
    (128, 32, 64, torch.float32, None, ("group_aggregate", None)),  # 1 tile
    (1024, 32, 64, torch.float32, None, ("group_aggregate_pipelined", None)),
    (512, 64, 128, torch.bfloat16, None,
     ("group_aggregate_pipelined", None)),
    (1024, 64, 64, torch.float32, False, ("group_aggregate", None)),
    (1024, 64, 512, torch.float32, None,                # past 256 channels
     ("group_aggregate_pipelined", None)),
    (1024, 64, 6, torch.float32, True, ("group_aggregate", None)),  # 24 B
    (65536, 32, 64, torch.float32, None, ("group_aggregate", None)),  # 1 MB
    (65536, 32, 64, torch.float32, True, ("group_aggregate", None)),
])
def test_group_aggregate_routes_by_neighbour_stages(monkeypatch, Np, k, Cc,
                                                    dtype, pipelined, want):
    """K13 where its plan copies two feature tiles or more (the
    reference's N // bn; ``pipelined`` overrides), else K12; rows that are
    not whole 16-byte chunks, and clouds of which no 16-byte slice fits a
    block, always K12."""
    calls = _record_calls(monkeypatch)
    feats = torch.zeros((1, Np, Cc), dtype=dtype)
    idx = torch.zeros((1, 8, k), dtype=torch.int32)
    pc_ops.group_aggregate(feats, idx, pipelined=pipelined)
    assert calls == [want]
    steps = pc_ops.group_steps(feats, idx)
    assert (want[0] == "group_aggregate_pipelined") == (
        steps >= 2 and pipelined is not False)


def test_ops_send_every_cloud_the_reference_kernels_take_to_the_kernels(
        monkeypatch):
    """No fallback beyond the reference's: 2-d points (the reference's
    kernels take any d) and centers of another dtype reach the kernel
    wrappers, which raise on CUDA tensors and compute the plain version on
    CPU tensors."""
    calls = _record_calls(monkeypatch)
    xyz = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, N, 2)).astype(np.float32))
    jx = jnp.asarray(xyz.numpy())
    sel = pc_ops.farthest_point_sample(xyz, M)
    np.testing.assert_array_equal(
        _t(sel), np.asarray(jax_pck.fps(jx, M, interpret=True)))
    idx = pc_ops.ball_query(xyz, xyz[:, :M], 0.9, K)
    np.testing.assert_array_equal(
        _t(idx), np.asarray(jax_pcops.ball_query(jx, jx[:, :M], 0.9, K,
                                                 interpret=True)))
    pc_ops.ball_query(xyz.bfloat16(), xyz[:, :M], 0.9, K)
    assert [name for name, _ in calls] == ["fps", "ball_query", "ball_query"]


@pytest.mark.parametrize("op,shape,kernel", [
    ("fps", (1, 200, 64), "fps"),
    ("fps", (1, 200, 300), None),                       # S > N
    ("ball_query", (1, 256, 64, 8), "ball_query"),
    ("ball_query", (1, 200, 65, 8), None),              # untileable
    ("group_aggregate", (1, 256, 64, 8, 32), "group_aggregate"),
    ("group_aggregate", (1, 200, 65, 8, 32), None),     # untileable
])
def test_lowering_config_runs_what_lower_records(monkeypatch, op, shape,
                                                 kernel):
    """``LoweringConfig``'s methods reach a kernel wrapper exactly where
    ``lower`` records ``isax``."""
    calls = _record_calls(monkeypatch)
    lw = LoweringConfig("cuda")
    decision = lw.lower(op, shape, torch.float32)
    assert decision.impl == ("isax" if kernel else "reference")
    assert (decision.note == pc_ops.fallback(op, shape)) == (kernel is None)
    xyz = torch.zeros((shape[0], shape[1], 3))
    if op == "fps":
        lw.fps(xyz, shape[2])
    elif op == "ball_query":
        lw.ball_query(xyz, xyz[:, :shape[2]], 0.5, shape[3])
    else:
        idx = torch.zeros(shape[:1] + shape[2:4], dtype=torch.int32)
        lw.group_aggregate(torch.zeros((shape[0], shape[1], shape[4])), idx)
    assert [name for name, _ in calls] == ([kernel] if kernel else [])


@pytest.mark.parametrize("Np,k,Cc,itemsize", [
    (1024, 64, 64, 4), (1024, 64, 256, 4), (1024, 128, 256, 2),
    (4096, 16, 64, 4), (65536, 32, 64, 4), (1024, 64, 300, 4)])
def test_group_depth_fits_shared_memory(Np, k, Cc, itemsize):
    """K13's plan (``group_plan``) fits in a block's shared memory, one
    slot a tile, at any row of whole 16-byte chunks (300 fp32 channels
    included: the channel slice lifts the old 256-channel limit), wherever
    a 16-byte slice of the cloud fits; elsewhere there is none, and the
    route takes K12."""
    plan = pipeline.group_plan(1, Np, 512, k, Cc, itemsize)
    if Np * 16 > pipeline.MAX_SMEM:
        assert plan is None
        assert pc_ops.group_steps(torch.zeros((1, Np, Cc)),
                                  torch.zeros((1, 512, k),
                                              dtype=torch.int32)) == 0
        return
    bn, cs, split, depth = plan
    assert depth == pipeline.group_tiles(Np, bn)
    assert Cc % cs == 0
    assert pipeline.group_smem_bytes(plan, 512, k, itemsize) <= (
        pipeline.MAX_SMEM)
    assert pipeline.group_plan(1, Np, 512, k, 6, 4) is None


FPS_SHAPES_N = [1, 31, 256, 1024, 1031, 4096, 8192, 8193, 9000, 16384,
                65536, 100000, 131072, 131073, 300000]


@pytest.mark.parametrize("N", FPS_SHAPES_N)
@pytest.mark.parametrize("Bc", [1, 2, 8, 16, 64, 200])
def test_fps_plan_is_legal(Bc, N):
    """``fps_plan`` returns a plan csrc/fps.cu takes: one block a cloud up
    to one block's capacity, else a cluster whose B copies the card runs
    at once (or one block a cloud); registers where the cluster holds the
    cloud (the fewest points a thread, at most 8), the scratch path where
    it does not, always above ``FPS_REGISTER_POINTS``."""
    cluster, threads, ppt = plan = pipeline.fps_plan(Bc, N)
    assert pipeline.fps_plan_legal(plan, N)
    assert (cluster == 1) == (N <= pipeline.FPS_BLOCK_POINTS
                              or Bc > pipeline.FPS_CLUSTERS_AT_ONCE[2])
    assert cluster == 1 or Bc <= pipeline.FPS_CLUSTERS_AT_ONCE[cluster]
    span = -(-N // cluster)
    assert (ppt == 0) == (span > pipeline.FPS_BLOCK_POINTS)
    if N > pck.FPS_REGISTER_POINTS:
        assert ppt == 0
    if ppt == 0:
        assert threads == (512 if cluster >= 8 else 1024)
        return
    assert threads * ppt >= span and (ppt == 1 or threads * ppt // 2 < span)
    assert threads == 256 or threads * 4 < span


def test_fps_register_points_is_the_plan_capacity():
    """The wrapper's capacity is the largest plan csrc/fps.cu is built
    for: 16 blocks of 1024 threads at 8 points a thread."""
    cap = max(c * t * p for c in pipeline.FPS_CLUSTERS
              for t in pipeline.FPS_THREADS for p in pipeline.FPS_PPTS)
    assert pck.FPS_REGISTER_POINTS == pipeline.FPS_CAPACITY == cap == 131072
    assert pipeline.fps_plan(1, cap)[2] > 0
    assert pipeline.fps_plan(1, cap + 1)[2] == 0


@pytest.mark.parametrize("N", [4096, 65536, pck.FPS_REGISTER_POINTS,
                               pck.FPS_REGISTER_POINTS + 1, 300000])
@pytest.mark.parametrize("Bc", [1, 3, 16])
def test_fps_scratch_follows_the_plan(Bc, N):
    """Global scratch (B·N floats) exactly where the plan takes the
    scratch path: above the register capacity, and where the cluster
    that lets all B clouds run at once cannot hold a cloud (16 clouds
    from 65536 points)."""
    want = Bc * N if (N > pck.FPS_REGISTER_POINTS
                      or (Bc == 16 and N >= 65536)) else 0
    assert pck.fps_scratch_floats(Bc, N, pipeline.fps_plan(Bc, N)) == want


@pytest.mark.parametrize("plan,N,legal", [
    ((1, 512, 8), 4096, True), ((16, 1024, 8), 131072, True),
    ((16, 512, 0), 10, True), ((3, 256, 8), 100, False),
    ((1, 128, 8), 100, False), ((1, 256, 16), 100, False),
    ((1, 256, 1), 4096, False), ((32, 256, 8), 100, False)])
def test_fps_plan_legal_is_what_the_kernel_takes(plan, N, legal):
    assert pipeline.fps_plan_legal(plan, N) is legal


@pytest.mark.parametrize("Bc,N,want", [
    (2, 4096, (1, 512, 8)),        # (a): the sweep's fastest
    (16, 1024, (1, 256, 4)),       # (b)
    (1, 65536, (16, 512, 8)),      # the large cloud
    (1, 8192, (1, 1024, 8)),       # one block's largest cloud
    (1, 16384, (8, 256, 8)),       # twice it: 256-thread blocks
    (1, 200000, (16, 512, 0)),     # the scratch path
    (1, 131072, (16, 1024, 8)),    # the largest cloud in registers
    (8, 65536, (8, 1024, 8)),      # 8 clusters of 16 would not run at once
    (16, 65536, (4, 1024, 0)),     # nor 16 of 8: scratch on 4 blocks
])
def test_fps_plan_picks_what_the_sweep_measured(Bc, N, want):
    assert pipeline.fps_plan(Bc, N) == want


def test_wrappers_take_the_plain_version_only_on_cpu_tensors():
    xyz, centers, feats, radius = _cloud("normal", "float32")
    idx = ref.ball_query_ref(xyz, centers, radius, K)
    torch.testing.assert_close(pck.fps(xyz, M), ref.fps_ref(xyz, M))
    for fn in (pck.ball_query, pck.ball_query_pipelined):
        torch.testing.assert_close(
            fn(xyz, centers, radius, K),
            ref.ball_query_ref(xyz, centers, radius, K))
    for fn in (pck.group_aggregate, pck.group_aggregate_pipelined):
        torch.testing.assert_close(fn(feats, idx),
                                   ref.group_aggregate_ref(feats, idx))
    meta = {"device": "meta"}
    mx, mf = torch.zeros((1, 8, 3), **meta), torch.zeros((1, 8, 4), **meta)
    mi = torch.zeros((1, 2, 2), dtype=torch.int32, **meta)
    for call in (lambda: pck.fps(mx, 2),
                 lambda: pck.ball_query(mx, mx, 1.0, 2),
                 lambda: pck.ball_query_pipelined(mx, mx, 1.0, 2),
                 lambda: pck.group_aggregate(mf, mi),
                 lambda: pck.group_aggregate_pipelined(mf, mi)):
        with pytest.raises(ValueError):
            call()


def test_fps_sm_ids_are_written_only_by_the_kernel():
    """A CPU cloud takes the plain version, which runs on no SM: asking it
    for the SMs raises rather than leaving the ids unwritten."""
    xyz = _cloud("normal", "float32")[0]
    with pytest.raises(ValueError):
        pck.fps(xyz, M, sm_ids=torch.zeros(8, dtype=torch.int32))


def test_kernels_name_the_tpu_kernels_they_replace():
    from repro_torch.kernels import _build
    lines = (ROOT / "src/repro/pointcloud/kernels.py").read_text().splitlines()
    for kern in (pck.FPS, pck.BALL_QUERY, pck.BALL_QUERY_PIPELINED,
                 pck.GROUP_AGGREGATE, pck.GROUP_AGGREGATE_PIPELINED):
        path, line = kern.replaces.split(":")
        assert path == "src/repro/pointcloud/kernels.py"
        assert lines[int(line) - 1].startswith(f"def {kern.name}(")
        assert (ROOT / kern.source).is_file()
        assert _build.KERNELS[kern.name] is kern


@pytest.mark.parametrize("argv", [[], ["--batch", "2", "--points", "512",
                                       "--centers", "64", "--k", "32",
                                       "--channels", "32", "--radius", "0.9",
                                       "--pipelined", "off"]])
def test_launcher_runs_on_cpu(argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pointcloud", "--device",
         "cpu", *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "parity vs backend torch OK" in out.stdout
    for op in ("fps", "ball_query", "group_aggregate"):
        assert f"{op} " in out.stdout and "impl=isax" in out.stdout
