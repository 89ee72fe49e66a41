"""The port's kernel modules on the CPU against the JAX kernels.

The same numpy inputs (seeded) go through the JAX Pallas kernels in
interpret mode and through the port's plain versions and ``ops`` wrappers on
CPU tensors.  Tolerances are the reference's own (tests/test_kernels.py):
fp32 atol 2e-5 / rtol 2e-4, bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import down_pow2 as jax_down_pow2
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.pipeline import flash_attention_pipelined as jax_flash_pipe
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.core.tiling import down_pow2
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _tol(name):
    """fp32 atol 2e-5 / rtol 2e-4; bf16, and fp16 (which keeps 3 more
    mantissa bits), the reference's 2e-2."""
    return (dict(atol=2e-5, rtol=2e-4) if name == "float32"
            else dict(atol=2e-2, rtol=2e-2))


def _pair(a: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _mask(kind: str, B: int, S: int, T: int, rng) -> np.ndarray:
    if kind == "causal":
        return np.tril(np.ones((S, T), bool), k=T - S)[None]
    if kind == "batch":   # a distinct (B,S,T) mask per example
        m = rng.random((B, S, T)) < 0.7
        m[:, :, 0] = True
        return m
    if kind == "block_sparse":   # dead key blocks mid-row, per example
        m = rng.random((B, S, T)) < 0.8
        for b in range(B):
            for c in range(16 * (1 + b % 2), T, 32):
                m[b, :, c:c + 16] = False
        return m
    if kind == "fully_masked_rows":   # tests/test_kernels.py:45
        m = np.zeros((1, S, T), bool)
        m[:, :, :8] = True
        m[:, :8, :] = False
        return m
    raise ValueError(kind)


@pytest.mark.parametrize("n,cap", [(16, 256), (96, 64), (11, 8), (512, 128),
                                   (1, 4)])
def test_down_pow2_matches_reference(n, cap):
    assert down_pow2(n, cap) == jax_down_pow2(n, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("R,d", [(16, 64), (8, 768), (24, 96), (8, 2560)])
def test_rmsnorm_matches_pallas(R, d, dtype):
    rng = np.random.default_rng(R * d)
    x_np = rng.normal(size=(R, d)).astype(np.float32)
    g_np = rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32)
    xj, xt = _pair(x_np, dtype)
    want = jax_rmsnorm(xj, jnp.asarray(g_np), eps=1e-6, block_rows=R,
                       interpret=True)
    g_t = torch.from_numpy(g_np)
    for got in (ref.rmsnorm_ref(xt, g_t, eps=1e-6),
                rmsnorm(xt, g_t, eps=1e-6),
                ops.rmsnorm(xt, g_t, eps=1e-6)):
        assert got.dtype == xt.dtype and got.shape == xt.shape
        np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))


FLASH_CASES = [
    # B, S, H, K, T, hd, mask kind
    (1, 64, 2, 2, 64, 16, "causal"),             # MHA
    (2, 64, 4, 2, 64, 16, "batch"),              # GQA 2:1, (B,S,T) mask
    (1, 32, 4, 2, 64, 32, "causal"),             # GQA, (1,S,T) mask, S < T
    (1, 64, 2, 1, 64, 16, "fully_masked_rows"),
    (2, 64, 2, 1, 96, 16, "block_sparse"),       # dead tiles differ per example
    (2, 32, 4, 4, 64, 32, "batch"),
]
# Head dims that run at a wider instantiation (80 and 96 at 128, 256 with
# one KV head as paligemma-3b's), and one not a multiple of 8.
WIDE_CASES = [
    (1, 32, 2, 2, 64, 80, "causal"),
    (1, 32, 2, 1, 32, 96, "batch"),
    (1, 32, 2, 1, 64, 256, "causal"),
    (1, 16, 2, 2, 16, 20, "causal"),
]


def _flash_inputs(B, S, H, K, T, hd, kind, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    m = _mask(kind, B, S, T, rng)
    jax_in = [_pair(a, dtype)[0] for a in (q, k, v)] + [jnp.asarray(m)]
    torch_in = [_pair(a, dtype)[1] for a in (q, k, v)] + [torch.from_numpy(m)]
    return jax_in, torch_in


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("B,S,H,K,T,hd,kind", FLASH_CASES + WIDE_CASES)
def test_flash_attention_matches_pallas(B, S, H, K, T, hd, kind, dtype):
    (qj, kj, vj, mj), (qt, kt, vt, mt) = _flash_inputs(
        B, S, H, K, T, hd, kind, dtype, seed=S + T + H)
    scale = hd ** -0.5
    want = jax_flash(qj, kj, vj, jnp.broadcast_to(mj, (mj.shape[0], S, T)),
                     sm_scale=scale, block_q=32, block_k=32, interpret=True)
    oracle = jref.flash_attention_ref(qj, kj, vj, mj, sm_scale=scale)
    for got in (ref.flash_attention_ref(qt, kt, vt, mt, sm_scale=scale),
                flash_attention(qt, kt, vt, mt, sm_scale=scale),
                ops.flash_attention_gqa(qt, kt, vt, mt, sm_scale=scale)):
        assert got.dtype == qt.dtype and got.shape == qt.shape
        np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))
        np.testing.assert_allclose(_np32(got), _np32(oracle), **_tol(dtype))
    if kind == "fully_masked_rows":
        np.testing.assert_allclose(_np32(got)[0, :8], 0.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("B,S,H,K,T,hd,kind", [FLASH_CASES[0], FLASH_CASES[1],
                                               FLASH_CASES[3], FLASH_CASES[4],
                                               WIDE_CASES[2]])
def test_flash_attention_pipelined_matches_pallas(B, S, H, K, T, hd, kind,
                                                  depth, dtype):
    (qj, kj, vj, mj), (qt, kt, vt, mt) = _flash_inputs(
        B, S, H, K, T, hd, kind, dtype, seed=depth + S)
    scale = hd ** -0.5
    want = jax_flash_pipe(qj, kj, vj,
                          jnp.broadcast_to(mj, (mj.shape[0], S, T)),
                          sm_scale=scale, block_q=32, block_k=16,
                          depth=depth, interpret=True)
    got = pipeline.flash_attention_pipelined(qt, kt, vt, mt, sm_scale=scale,
                                             depth=depth)
    np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))
    forced = ops.flash_attention_gqa(qt, kt, vt, mt, sm_scale=scale,
                                     pipelined=True)
    np.testing.assert_allclose(_np32(forced), _np32(want), **_tol(dtype))


def test_untileable_head_dim_falls_back_to_reference():
    """Every head dim up to 256 is tileable (hd = 24 runs at width 32); one
    above 256 is not, and the attention layer then takes the plain version
    through ``lower``, as the reference's wrapper does for shapes its
    kernel cannot tile.  The ops wrapper itself never falls back."""
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.kernels.flash_attention import padded_head_dim
    from repro_torch.models import layers
    assert ops.flash_tileable(2, 2, 24, torch.float16)
    assert padded_head_dim(24) == 32 and padded_head_dim(256) == 256
    assert not ops.flash_tileable(2, 2, 320, torch.float32)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(1, 16, 2, 320)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 16, 2, 320)).astype(np.float32))
    m = torch.ones((1, 16, 16), dtype=torch.bool)
    lw = LoweringConfig("cuda")
    assert lw.lower("attention", (1, 16, 2, 2, 16, 320),
                    torch.float32).impl == "reference"
    got = layers.sdpa(q, k, k, m, 320, lw)
    want = layers._sdpa_xla(q, k, k, m, 320)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("n_steps,override,want", [
    (1, None, False), (1, True, False), (2, None, True), (8, False, False),
    (4, True, True)])
def test_use_pipeline_never_pipelines_one_tile(n_steps, override, want):
    """The routes' choice between a kernel and its pipelined variant
    (``ops.chosen`` over ``kernels/schedule.py``), for an SSD sweep of
    ``n_steps`` 16-position chunks at mamba2-2.7b's widths: a single
    streamed tile never takes the ring, not even when forced (the schedule
    offers none); else ``override`` where given, and by default the cost
    model's pick, which is the ring from two chunks up there."""
    from repro_torch.kernels import schedule
    sched = schedule.ssd_schedule(4, 16 * n_steps, 80, 64, 128, 4)
    assert (sched["pipe"] is None) is (n_steps < 2)
    got = ops.chosen(sched, override)["kernel"] == "ssd_scan_pipelined"
    assert got is want


@pytest.mark.parametrize("hd,itemsize,n_steps,want", [
    (64, 4, 8, 2), (64, 4, 2, 2), (64, 4, 3, 2), (128, 4, 8, 2),
    (128, 2, 8, 2), (80, 4, 8, 2), (96, 2, 8, 2), (256, 4, 8, 2),
    (256, 2, 8, 2), (64, 2, 8, 2), (32, 4, 8, 2), (16, 2, 2, 2)])
def test_choose_depth_fits_shared_memory(hd, itemsize, n_steps, want):
    depth = pipeline.choose_depth(hd, itemsize, n_steps)
    assert depth == want
    assert pipeline.ring_smem_bytes(hd, itemsize, depth) <= pipeline.MAX_SMEM


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 80, 96, 128, 200, 256])
def test_choose_depth_keeps_the_most_blocks_an_sm(hd, itemsize):
    """The depth whose block leaves room for the most blocks on the SM,
    the deepest of those; never a ring that does not fit."""
    fit = {d: pipeline.blocks_fit(pipeline.ring_smem_bytes(hd, itemsize, d))
           for d in pipeline.DEPTHS}
    depth = pipeline.choose_depth(hd, itemsize, 8)
    assert fit[depth] == max(fit.values()) >= 1
    assert all(fit[d] < fit[depth] for d in pipeline.DEPTHS if d > depth)
    assert pipeline.ring_smem_bytes(hd, itemsize, depth) <= pipeline.MAX_SMEM


@pytest.mark.parametrize("fits,want", [
    ({2: 3, 3: 3, 4: 2}, 3), ({2: 1, 3: 1, 4: 1}, 4), ({2: 1, 3: 0, 4: 0}, 2),
    ({2: 2, 3: 1, 4: 1}, 2)])
def test_choose_depth_takes_the_deepest_of_equal_occupancy(monkeypatch, fits,
                                                           want):
    monkeypatch.setattr(pipeline, "ring_smem_bytes", lambda hd, it, d: d)
    monkeypatch.setattr(pipeline, "blocks_fit", lambda smem: fits[smem])
    assert pipeline.choose_depth(64, 4, 8) == want
    assert pipeline.choose_depth(64, 4, 2) == 2


def test_choose_depth_raises_where_no_ring_fits(monkeypatch):
    monkeypatch.setattr(pipeline, "blocks_fit", lambda smem: 0)
    with pytest.raises(ValueError):
        pipeline.choose_depth(64, 4, 8)


def test_ring_smem_bytes_gives_two_fp32_blocks_at_hd_64():
    """At the served shape (hd 64, fp32) a depth-2 block and the SM's 1 KB
    reserve fit twice in the SM's 228 KB; depth 3 fits once."""
    two = pipeline.ring_smem_bytes(64, 4, 2)
    assert 2 * (two + pipeline.BLOCK_RESERVED_SMEM) <= pipeline.SM_SMEM
    assert pipeline.blocks_fit(pipeline.ring_smem_bytes(64, 4, 3)) == 1
    # bf16 keeps K/V 16-bit: a depth-4 ring still leaves two blocks, a
    # depth-2 ring four
    assert pipeline.blocks_fit(pipeline.ring_smem_bytes(64, 2, 4)) == 2
    assert pipeline.blocks_fit(pipeline.ring_smem_bytes(64, 2, 2)) == 4


@pytest.mark.parametrize("S,T,hd,kind", [
    (512, 512, 64, "causal"), (130, 70, 64, "batch"), (64, 96, 256, "batch"),
    (100, 300, 64, "block_sparse"), (33, 50, 20, "fully_masked_rows"),
    (70, 40, 64, "dead_one_tile")])
def test_live_tiles_counts_tiles_with_a_valid_entry(S, T, hd, kind):
    """``live_tiles`` is the count of (64-row q tile, K/V tile) pairs with
    one valid entry, the tiles the kernels compute, against a loop; a
    sweep of one K/V tile is not scanned, so its tiles all count."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(S + T)
    if kind == "dead_one_tile":       # the first q tile wholly masked
        m = np.ones((1, S, T), bool)
        m[:, :64] = False
    else:
        m = _mask(kind, 2, S, T, rng)
    if kind == "batch":
        m[:, :, 64:] &= rng.random((2, S, T - 64)) < 0.002
    bk = fa.block_k(hd)
    one_tile = T <= bk
    want = sum(one_tile or bool(m[b, i:i + 64, j:j + bk].any())
               for b in range(m.shape[0]) for i in range(0, S, 64)
               for j in range(0, T, bk))
    total = m.shape[0] * -(-S // 64) * -(-T // bk)
    assert fa.live_tiles(torch.from_numpy(m), hd) == (want, total)
    if kind == "causal":
        assert (want, total) == (36, 64)


@pytest.mark.parametrize("kernel", ["flash_attention", "pipelined",
                                    "int8kv"])
def test_flash_wrappers_take_no_live_count_on_the_cpu(kernel):
    """Only a kernel counts the tiles it computes: a CPU call (the plain
    version) refuses a counter rather than leave it unwritten."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 8, 2, 16))
    m = torch.ones((1, 8, 8), dtype=torch.bool)
    count = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="live_count"):
        if kernel == "flash_attention":
            fa.flash_attention(q, kv, kv, m, sm_scale=0.25, live_count=count)
        elif kernel == "pipelined":
            pipeline.flash_attention_pipelined(q, kv, kv, m, sm_scale=0.25,
                                               live_count=count)
        else:
            s = torch.ones(2)
            fa.flash_attention_int8kv(q, kv.to(torch.int8), kv.to(torch.int8),
                                      s, s, m, sm_scale=0.25,
                                      live_count=count)


@pytest.mark.parametrize("stage_bytes,n_steps,cap,want", [
    (1_000, 8, 4, 4), (1_000, 3, 4, 3), (1_000, 1, 4, 2), (1_000, 8, 3, 3),
    (70_000, 8, 4, 3), (120_000, 8, 4, None)])
def test_deepest_ring_is_the_deepest_that_fits(stage_bytes, n_steps, cap,
                                               want):
    assert pipeline.deepest_ring(lambda d: d * stage_bytes, n_steps,
                                 cap) == want


K1 = rmsnorm_mod


@pytest.mark.parametrize("R,d,itemsize,want", [
    (512, 768, 4, (K1.ROW, 2, 96)),          # llama110m prefill, fp32
    (8, 768, 4, (K1.ROW, 2, 96)),            # llama110m decode
    (4096, 768, 2, (K1.ROW, 2, 64)),
    (2048, 2560, 2, (K1.ROW, 2, 160)),       # mamba2 norm, bf16
    (2048, 5120, 2, (K1.ROWS, 1, 640)),      # mamba2 gate norm, bf16
    (4, 5120, 2, (K1.ROW, 2, 320)),          # ... in a decode step
    (2048, 5120, 4, (K1.ROW, 2, 640)),       # mamba2 gate norm, fp32
    (2048, 2560, 4, (K1.ROW, 2, 320)),
    (64, 16, 4, (K1.ROW, 2, 32)),
    (100, 100, 2, (K1.LOOP, 0, 128)),        # rows not whole vectors
    (8, 1 << 16, 4, (K1.LOOP, 0, 128)),      # too wide for registers
])
def test_rmsnorm_plan_holds_every_vector_of_the_row(R, d, itemsize, want):
    """K1's shape: a block a row at two vectors a thread (more only past
    1024 threads); 16-bit rows of 512-1024 vectors that every resident
    block would meet twice walk the rows one ahead; the loop kernel where a
    row is not whole vectors or too wide for registers."""
    got = K1.plan(R, d, itemsize)
    assert tuple(got) == want
    if got.mode != K1.LOOP:
        assert got.vpt * got.threads * (16 // itemsize) >= d
        assert got.vpt <= (K1.MAX_ROWS_VPT if got.mode == K1.ROWS
                           else K1.MAX_VPT)
        assert got.threads <= K1.MAX_ROW_THREADS


@pytest.mark.parametrize("R,threads,sms,want", [
    (2048, 640, 132, 342), (2048, 320, 132, 683), (100, 640, 132, 100),
    (396, 640, 132, 396), (397, 640, 132, 199)])
def test_rmsnorm_rows_grid_evens_out_the_rows(R, threads, sms, want):
    """The ROWS grid is resident (2048 threads an SM) and every block
    walks ceil(R / grid) or one fewer rows."""
    grid = K1.rows_grid(R, threads, sms)
    assert grid == want
    assert grid <= sms * (K1.SM_THREADS // threads)
    per = -(-R // grid)
    assert (per - 1) * grid < R <= per * grid
