"""The arithmetic of the int8 GEMM kernels (``csrc/int8_tile.cuh``, K4 and
K5) against the JAX package's ``int8_matmul`` Pallas kernel in interpret
mode, and the plan rule both wrappers follow (``pipeline.int8_plan``).

The kernels run on bf16/fp16 tensor cores: every int8 value is exact in
bf16 and fp16, and an fp32 x is cut into three bf16 terms by masking bits,
hi + mid + lo == x, so each product x·w is three exact products and only
the fp32 sums round.  The plain-torch model below does the same: the
split by bit masking, exact products, an fp32 rounding after every k-group
of 16 (one tensor-core step) and the per-stage sum added into the running
fp32 total (the kernels' promotion every 64 k).  It must hold the kernels'
fp32 tolerance, K ulps (2^-23) of the largest product |x|·|scale·wq|
(``chip_smoke.int8_tol``), at K = 768 and 2048; one bf16 pass (hi alone)
must not: that is why the kernels split.  Inputs come from numpy seeds;
runs in seconds.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro_torch.kernels import pipeline

FLT_MAX = float(np.finfo(np.float32).max)
TINY = float(np.finfo(np.float32).tiny)        # 2^-126, the smallest normal


def split3(x: torch.Tensor):
    """x (fp32) → (hi, mid, lo), each an fp32 whose low 16 bits are zero
    (a bf16), as ``i8mm::split3``: hi = x's top 16 bits, mid the top 16
    of the exact remainder x - hi, lo those of what is left."""
    def top16(a):
        return (a.contiguous().view(torch.int32) & -65536).view(torch.float32)
    hi = top16(x)
    r = x - hi
    mid = top16(r)
    return hi, mid, top16(r - mid)


def low16(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32) & 0xFFFF


def test_split_is_exact_for_normals_down_to_2_pow_minus_110():
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, size=4096),
            rng.normal(size=1024),
            [FLT_MAX, -FLT_MAX, TINY, -TINY, 2.0 ** -110, -(2.0 ** -110),
             0.0, -0.0, 1.0, -1.0, 3.0 ** 20, 1.0 / 3.0]]
    x = torch.from_numpy(np.concatenate(vals).astype(np.float32))
    x = x[(x.abs() >= 2.0 ** -110) | (x == 0)]
    hi, mid, lo = split3(x)
    for t in (hi, mid, lo):
        assert (low16(t) == 0).all() and torch.isfinite(t).all()
    # the fp32 sum of the three terms gives x back bit for bit; -0 comes
    # back as +0 (its remainder is +0), which no product sum can tell apart
    back = (hi + mid) + lo
    nz = x != 0
    assert torch.equal(back[nz].view(torch.int32), x[nz].view(torch.int32))
    assert (back[~nz] == 0).all()
    # each term is exact in bf16, so the tensor cores read what the sum holds
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)


def test_split_of_subnormals_and_tiny_normals_drops_under_2_pow_minus_133():
    """Below 2^-110 a remainder turns subnormal and masking drops its bits
    under 2^-133: the sum misses x by less than 2^-133, and stays finite."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-1, 1, 4096) * 2.0 ** -110,
                        rng.uniform(-1, 1, 4096) * TINY,
                        [TINY * 2.0 ** -23, -TINY * 2.0 ** -23]])
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = split3(x)
    err = ((hi.double() + mid.double() + lo.double()) - x.double()).abs()
    assert float(err.max()) < 2.0 ** -133
    assert (low16(hi) == 0).all() and (low16(mid) == 0).all()
    assert (low16(lo) == 0).all()


def test_int8_widens_exactly_to_bf16_and_fp16():
    """All 256 int8 values through the kernels' bit tricks (``widen4``):
    bf16 -- i8x4_to_f32 (byte xor 0x80 spliced under 2^23, minus 2^23 +
    128), its top 16 bits; fp16 -- the biased byte spliced under fp16's
    1024 (0x64), minus 1152 in fp16."""
    v = np.arange(-128, 128, dtype=np.int32)
    b = (v & 0xFF) ^ 0x80                       # the byte, biased to unsigned
    f32 = (np.uint32(0x4B000000) | b.astype(np.uint32)).view(np.float32)
    f32 = (f32 - np.float32(8388736.0)).astype(np.float32)
    assert np.array_equal(f32, v.astype(np.float32))
    bits = f32.view(np.uint32)
    assert not (bits & 0xFFFF).any()            # the bf16 is its top 16 bits
    bf16 = torch.from_numpy((bits >> 16).astype(np.int16)).view(torch.bfloat16)
    assert torch.equal(bf16.float(), torch.from_numpy(v.astype(np.float32)))
    h = ((np.uint16(0x6400) | b.astype(np.uint16)).view(np.float16)
         - np.float16(1152.0))
    assert h.dtype == np.float16
    assert np.array_equal(h.astype(np.float32), v.astype(np.float32))


def kernel_sum(x, wq, scale, passes: int):
    """(x @ wq^T) · scale as the kernels sum it: the terms of x (lo, mid,
    hi for 3 passes; hi alone for 1), each k-group of 16 an exact product
    sum rounded once to fp32 into the stage's accumulator, and every
    64-wide stage added into the running fp32 total."""
    hi, mid, lo = split3(x)
    terms = (lo, mid, hi) if passes == 3 else (hi,)
    w = wq.double()
    K = x.shape[1]
    total = torch.zeros((x.shape[0], wq.shape[0]), dtype=torch.float32)
    for k0 in range(0, K, 64):
        acc = torch.zeros_like(total)
        for t in terms:
            for j in range(k0, min(k0 + 64, K), 16):
                group = t[:, j:j + 16].double() @ w[:, j:j + 16].T
                acc = (acc.double() + group).float()
        total = (total.double() + acc.double()).float()
    return total * scale


def _inputs(M, N, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(N, K)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, size=(N,)).astype(np.float32)
    return x, wq, scale


def _k_ulps(x, wq, scale) -> float:
    """``chip_smoke.int8_tol``'s fp32 atol: K ulps of the largest product."""
    big = (np.abs(x).max()
           * np.abs(scale[:, None] * wq.astype(np.float32)).max())
    return x.shape[1] * float(big) * 2.0 ** -23


def _pallas(x, wq, scale):
    return np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                      jnp.asarray(scale), block_m=16,
                                      block_n=64, block_k=256,
                                      interpret=True))


@pytest.mark.parametrize("K", [768, 2048])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_exact_terms_hold_k_ulps_of_the_pallas_kernel(K, seed):
    x, wq, scale = _inputs(16, 64, K, seed)
    want = _pallas(x, wq, scale)
    got = kernel_sum(torch.from_numpy(x), torch.from_numpy(wq),
                     torch.from_numpy(scale), passes=3).numpy()
    np.testing.assert_allclose(got, want, atol=_k_ulps(x, wq, scale), rtol=0)


@pytest.mark.parametrize("K", [768, 2048])
def test_one_bf16_pass_falls_outside_k_ulps(K):
    x, wq, scale = _inputs(16, 64, K, 0)
    want = _pallas(x, wq, scale)
    got = kernel_sum(torch.from_numpy(x), torch.from_numpy(wq),
                     torch.from_numpy(scale), passes=1).numpy()
    outside = np.abs(got - want) > _k_ulps(x, wq, scale)
    assert outside.mean() > 0.5


# ---------------------------------------------------------------------------
# int8_plan: the plan rule of K4 and K5
# ---------------------------------------------------------------------------

PLAN_M = (1, 7, 8, 33, 64, 65, 100, 512, 513, 4096)
PLAN_N = (1, 33, 768, 1000, 2048, 32000)
PLAN_K = (16, 64, 100, 768, 2048, 2050)


def _shapes(pipelined: bool):
    for M, N, K in itertools.product(PLAN_M, PLAN_N, PLAN_K):
        if not pipelined or K % 16 == 0:
            yield M, N, K


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("pipelined", [False, True])
def test_int8_plan_is_legal_and_fits(pipelined, itemsize):
    for M, N, K in _shapes(pipelined):
        plan = pipeline.int8_plan(M, N, K, itemsize, pipelined=pipelined)
        assert pipeline.int8_plan_legal(plan, M, N, K, itemsize,
                                        pipelined=pipelined), (M, N, K, plan)
        tile_m, tile_n, split, depth = plan
        stages = -(-K // 64)
        assert split <= stages and depth <= max(2, -(-stages // split))
        if pipelined:
            smem = pipeline.k5_smem_bytes(*plan, itemsize, K)
        else:
            smem = pipeline.k4_smem_bytes(*plan, itemsize)
        assert smem <= pipeline.MAX_SMEM


def test_every_plan_is_a_legal_tensor_core_tile():
    """K4: 64 rows a consumer warpgroup, wgmma widths (a multiple of 8 up
    to 256), 256 only for 16-bit x; K5: mma.sync's 8-wide n side for the
    rows of x and 16 rows of wq a warp; every enumerated plan fits."""
    for itemsize in (4, 2):
        for M, N, K in ((512, 32000, 768), (8, 768, 2048), (100, 33, 80)):
            k4 = pipeline.int8_plans(M, N, K, itemsize, pipelined=False)
            k5 = pipeline.int8_plans(M, N, K, itemsize, pipelined=True)
            assert k4 and k5
            for tile_m, tile_n, split, depth in k4:
                assert tile_m % 64 == 0 and tile_n % 8 == 0 and tile_n <= 256
                assert tile_n < 256 or itemsize == 2
                assert pipeline.k4_smem_bytes(tile_m, tile_n, split, depth,
                                              itemsize) <= pipeline.MAX_SMEM
            for tile_m, tile_n, split, depth in k5:
                assert tile_m % 8 == 0 and tile_n % 16 == 0
                assert pipeline.k5_smem_bytes(tile_m, tile_n, split, depth,
                                              itemsize, K) <= pipeline.MAX_SMEM


@pytest.mark.parametrize("itemsize", [4, 2])
def test_int8_plan_splits_k_only_where_the_grid_leaves_sms_idle(itemsize):
    """K4 splits only where its unsplit grid has fewer blocks than the
    card's SMs, K5 fewer than two an SM; a split grid stays within that."""
    for pipelined, per_sm in ((False, 1), (True, 2)):
        for M, N, K in _shapes(pipelined):
            tile_m, tile_n, split, _ = pipeline.int8_plan(
                M, N, K, itemsize, pipelined=pipelined)
            blocks = -(-M // tile_m) * -(-N // tile_n)
            if split > 1:
                assert blocks * split <= per_sm * pipeline.SMS, (M, N, K)


# The rule's picks at the (i2) shapes, each measured against every plan in
# chip_smoke.int8_sweep_phase (PERF.md §6): the fastest, or within 4 % of it.
I2_PICKS = {
    # (M, K, N, itemsize): (tile_m, tile_n, split, depth)
    (512, 768, 768, 4): (128, 128, 4, 3),
    (512, 768, 768, 2): (128, 128, 4, 3),
    (512, 768, 2048, 4): (128, 64, 1, 3),
    (512, 768, 2048, 2): (128, 64, 1, 3),
    (512, 2048, 768, 4): (128, 128, 4, 3),
    (512, 2048, 768, 2): (128, 128, 4, 3),
    (512, 768, 32000, 4): (128, 128, 1, 3),
    (512, 768, 32000, 2): (128, 256, 1, 3),
    (8, 768, 768, 4): (8, 64, 8, 2),
    (8, 768, 768, 2): (8, 64, 8, 2),
    (8, 768, 2048, 4): (8, 64, 8, 2),
    (8, 768, 2048, 2): (8, 64, 8, 2),
    (8, 2048, 768, 4): (8, 64, 8, 2),
    (8, 2048, 768, 2): (8, 64, 8, 2),
    (8, 768, 32000, 4): (8, 128, 1, 2),
    (8, 768, 32000, 2): (8, 128, 1, 2)}


@pytest.mark.parametrize("key", sorted(I2_PICKS))
def test_int8_plan_picks_at_the_swept_i2_shapes(key):
    M, K, N, itemsize = key
    assert pipeline.int8_plan(M, N, K, itemsize,
                              pipelined=M <= 64) == I2_PICKS[key]
