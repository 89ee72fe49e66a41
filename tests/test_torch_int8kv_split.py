"""The arithmetic of the int8-K/V flash kernel K6 (``csrc/int8kv_tile.cuh``)
against the JAX package's ``flash_attention_int8kv`` Pallas kernel in
interpret mode, and K6's plan rule (``pipeline.int8kv_plan``).

K6 runs on bf16/fp16 tensor cores: every int8 is exact in bf16 and fp16,
and an fp32 q -- and each p of the softmax -- is cut into three bf16 terms
by masking bits, hi + mid + lo == x, so every product is exact and only
the fp32 sums round.  The plain-torch model below does what the kernel
does, in its order: 64-row q tiles, K/V tiles of ``block_k(hd)`` keys from
the live list of the tile's mask rows, split over the ranks of a cluster
(rank r takes entries r, r + split, ...); scores as three exact passes
rounded to fp32 after every 16-deep step, each 64-deep slice summed apart
and added (promotion); ``k_scale · sm_scale · log2 e`` one multiply a score;
the online softmax in log2 units; P V as three passes into a fresh
accumulator a tile added to the fp32 total; ``v_scale`` at the end; the
ranks' (m, l, acc) combined in rank order.  It must hold K6's fp32
tolerance (atol 2e-5, rtol 1e-4: tests/test_kernels.py:124) against the
Pallas kernel; one bf16 pass of q and p must not: that is why the kernel
splits.  Inputs come from numpy seeds; runs in seconds.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    flash_attention_int8kv as jax_flash_int8kv
from repro_torch.kernels import pipeline
from repro_torch.kernels.flash_attention import (BLOCK_Q, block_k,
                                                 live_tiles, padded_head_dim)

LOG2E = np.float32(1.4426950408889634)
NEG = -1e30


def top16(a: torch.Tensor) -> torch.Tensor:
    return (a.contiguous().view(torch.int32) & -65536).view(torch.float32)


def split3(x: torch.Tensor):
    """x (fp32) → (hi, mid, lo), each an fp32 whose low 16 bits are zero,
    hi + mid + lo == x (``i8mm::split3``)."""
    hi = top16(x)
    r = x - hi
    mid = top16(r)
    return hi, mid, top16(r - mid)


def terms(x: torch.Tensor, passes: int, dtype: torch.dtype):
    """The tensor-core operands of x, smallest first: fp32's three bf16
    terms (or hi alone for one pass), 16-bit q's value itself."""
    if dtype != torch.float32:
        return [x.to(dtype).float()]
    return list(reversed(split3(x))) if passes == 3 else [split3(x)[0]]


def tc_sum(a_terms, b, acc, depth_slice=None):
    """acc (fp32, (..., M, N)) plus sum_t a_t @ b^T over the last dim of
    a_t (..., M, D) and b (..., N, D), as the tensor cores sum it: each
    16-deep step of each term an exact sum rounded once into the fp32
    accumulator; with ``depth_slice``, each slice of that many columns
    into a fresh accumulator added to ``acc``."""
    D = b.shape[-1]
    step = depth_slice or D
    bd = b.double()
    for s0 in range(0, D, step):
        f = torch.zeros_like(acc)
        for d in range(s0, min(s0 + step, D), 16):
            for t in a_terms:
                g = t[..., d:d + 16].double() @ bd[..., d:d + 16].transpose(-1, -2)
                f = (f.double() + g).float()
        acc = f if depth_slice is None and s0 == 0 else (acc + f)
    return acc


def live_list(mask_rows: torch.Tensor, bk: int) -> list[int]:
    """The K/V tiles of one q tile's mask rows (64, T) with a valid entry;
    a sweep of one tile is not scanned: that tile is listed."""
    T = mask_rows.shape[1]
    nt = -(-T // bk)
    if nt == 1:
        return [0]
    return [t for t in range(nt) if bool(mask_rows[:, t * bk:(t + 1) * bk].any())]


def kernel_sum(q, k8, v8, k_scale, v_scale, mask, sm_scale: float,
               split: int = 1, passes: int = 3):
    """K6's output for q (B,S,H,hd) of q's dtype, summed as the kernel
    sums it (module docstring), and the K/V tiles each rank computed."""
    B, S, H, hd = q.shape
    T, K = k8.shape[1], k8.shape[2]
    G = H // K
    HD, bk = padded_head_dim(hd), block_k(hd)
    slice_ = 64 if HD > 64 else None
    dtype = q.dtype
    out = torch.zeros((B, S, H, hd), dtype=torch.float32)
    computed = [0] * split
    pad = (0, HD - hd)
    qf = torch.nn.functional.pad(q.float(), pad)
    kf = torch.nn.functional.pad(k8.float(), pad)
    vf = torch.nn.functional.pad(v8.float(), pad)
    c = (k_scale.float() * np.float32(sm_scale)) * torch.tensor(LOG2E)  # (K,)
    c = c.repeat_interleave(G)[:, None, None]                          # (H,1,1)
    vs = v_scale.float().repeat_interleave(G)[:, None]                  # (H,1)
    for b in range(B):
        mb = mask[b if mask.shape[0] > 1 else 0]
        for q0 in range(0, S, BLOCK_Q):
            rows = min(BLOCK_Q, S - q0)
            mrow = torch.zeros((BLOCK_Q, T), dtype=torch.bool)
            mrow[:rows] = mb[q0:q0 + rows]
            qt = torch.zeros((H, BLOCK_Q, HD))
            qt[:, :rows] = qf[b, q0:q0 + rows].transpose(0, 1)
            q_terms = terms(qt, passes, dtype)
            lst = live_list(mrow[:rows], bk)
            parts = []
            for r in range(split):
                m = torch.full((H, BLOCK_Q), NEG)
                l = torch.zeros((H, BLOCK_Q))
                o = torch.zeros((H, BLOCK_Q, HD))
                for t in lst[r::split]:
                    computed[r] += 1
                    k0 = t * bk
                    kt = torch.zeros((H, bk, HD))
                    vt = torch.zeros((H, bk, HD))
                    n = min(bk, T - k0)
                    kt[:, :n] = kf[b, k0:k0 + n].repeat_interleave(G, dim=1).transpose(0, 1)
                    vt[:, :n] = vf[b, k0:k0 + n].repeat_interleave(G, dim=1).transpose(0, 1)
                    ok = torch.zeros((BLOCK_Q, bk), dtype=torch.bool)
                    ok[:, :n] = mrow[:, k0:k0 + n]
                    s = tc_sum(q_terms, kt, torch.zeros((H, BLOCK_Q, bk)), slice_)
                    s = torch.where(ok, s * c, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(ok, torch.exp2(s - m_new[..., None]),
                                    torch.tensor(0.0))
                    l = alpha * l + p.sum(-1)
                    m = m_new
                    o = o * alpha[..., None]
                    fresh = tc_sum(terms(p, passes, dtype), vt.transpose(1, 2),
                                   torch.zeros_like(o))
                    o = o + fresh
                parts.append((m, l, o))
            if split == 1:
                m, l, o = parts[0]
                res = o * (vs / torch.clamp(l, min=1e-30))[..., None]
            else:
                M = torch.stack([p[0] for p in parts]).amax(0)
                L = torch.zeros_like(M)
                A = torch.zeros_like(parts[0][2])
                for m, l, o in parts:
                    w = torch.exp2(m - M)
                    L = L + w * l
                    A = A + w[..., None] * o
                res = A * (vs / torch.clamp(L, min=1e-30))[..., None]
            out[b, q0:q0 + rows] = res[:, :rows, :hd].transpose(0, 1)
    return out.to(dtype), computed


def _inputs(B, S, T, H, K, hd, seed, dead_rows=0, mask_kind="causal"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    kf = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    vf = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    ks = (np.abs(kf).max(axis=(0, 1, 3)) / 127.0).astype(np.float32)
    vs = (np.abs(vf).max(axis=(0, 1, 3)) / 127.0).astype(np.float32)
    k8 = np.clip(np.round(kf / ks[None, None, :, None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs[None, None, :, None]), -127, 127).astype(np.int8)
    if mask_kind == "causal":
        mask = np.tril(np.ones((S, T), bool), k=T - S)[None]
    else:                                        # random, per batch
        mask = rng.uniform(size=(B, S, T)) < 0.5
    mask = mask.copy()
    mask[:, :dead_rows, :] = False
    return q, k8, v8, ks, vs, mask


def _pallas(q, k8, v8, ks, vs, mask, scale):
    return np.asarray(jax_flash_int8kv(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(mask), sm_scale=scale, interpret=True))


CASES = [  # B, S, T, H, K, hd, dead rows, mask
    (1, 128, 128, 4, 2, 64, 0, "causal"),        # GQA
    (1, 64, 128, 2, 2, 80, 0, "causal"),         # width 128, ragged columns
    (1, 128, 128, 2, 1, 96, 8, "causal"),        # and fully masked rows
    (1, 64, 128, 2, 1, 256, 0, "causal"),        # 32-key tiles, MQA
    (2, 128, 256, 2, 2, 64, 0, "random"),        # a mask per batch
    (1, 64, 64, 2, 2, 32, 4, "causal")]          # one tile: rank 1 idles


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("B,S,T,H,K,hd,dead,kind", CASES)
def test_kernel_sum_holds_the_pallas_kernel(B, S, T, H, K, hd, dead, kind,
                                            split):
    q, k8, v8, ks, vs, mask = _inputs(B, S, T, H, K, hd, S + hd + split,
                                      dead, kind)
    scale = hd ** -0.5
    want = _pallas(q, k8, v8, ks, vs, mask, scale)
    t = [torch.from_numpy(a) for a in (q, k8, v8, ks, vs, mask)]
    got, computed = kernel_sum(*t, scale, split=split)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    assert not got[:, :dead].any()                 # rows with no key are 0
    # the ranks' tiles add up to the mask's live tiles
    assert sum(computed) == B // mask.shape[0] * live_tiles(t[5], hd)[0]


def test_a_split_part_without_a_live_tile_adds_nothing():
    """Causal q tile 0 of S = T = 128 has one live tile: at split 4 three
    ranks hold m = -1e30, l = 0 and the combine gives rank 0's answer."""
    q, k8, v8, ks, vs, mask = _inputs(1, 128, 128, 2, 2, 64, 5)
    t = [torch.from_numpy(a) for a in (q, k8, v8, ks, vs, mask)]
    one, c1 = kernel_sum(*t, 0.125, split=1)
    four, c4 = kernel_sum(*t, 0.125, split=4)
    assert c4 == [2, 1, 0, 0] and sum(c1) == 3
    np.testing.assert_allclose(four[:, :64].numpy(), one[:, :64].numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_sum_in_16_bit_holds_the_pallas_kernel(dtype):
    """bf16 and fp16 q: one pass, P rounded to q's type (2e-2)."""
    q, k8, v8, ks, vs, mask = _inputs(1, 128, 128, 4, 2, 64, 9)
    q16 = torch.from_numpy(q).to(dtype)
    want = _pallas(q16.float().numpy(), k8, v8, ks, vs, mask, 0.125)
    t = [torch.from_numpy(a) for a in (k8, v8, ks, vs, mask)]
    got, _ = kernel_sum(q16, *t, 0.125, split=2, passes=1)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd", [64, 256])
def test_one_bf16_pass_falls_outside_the_fp32_tolerance(hd):
    q, k8, v8, ks, vs, mask = _inputs(1, 128, 128, 2, 2, hd, 3)
    scale = hd ** -0.5
    want = _pallas(q, k8, v8, ks, vs, mask, scale)
    t = [torch.from_numpy(a) for a in (q, k8, v8, ks, vs, mask)]
    got, _ = kernel_sum(*t, scale, passes=1)
    outside = np.abs(got.numpy() - want) > 2e-5 + 1e-4 * np.abs(want)
    assert outside.mean() > 0.3


# ---------------------------------------------------------------------------
# int8kv_plan: K6's plan rule
# ---------------------------------------------------------------------------

PLAN_B = (1, 2, 8)
PLAN_S = (1, 64, 100, 512, 4096)
PLAN_HK = ((12, 12), (12, 4), (8, 1), (32, 8))
PLAN_HD = (6, 16, 32, 64, 80, 128, 256)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _plan_shapes():
    for B, S, (H, K), hd, dtype in itertools.product(PLAN_B, PLAN_S, PLAN_HK,
                                                     PLAN_HD, DTYPES):
        yield B, S, S, H, K, hd, dtype


def test_int8kv_plan_is_legal_and_fits():
    for shape in _plan_shapes():
        plan = pipeline.int8kv_plan(*shape)
        assert pipeline.int8kv_plan_legal(plan, *shape), (shape, plan)
        assert plan in pipeline.int8kv_plans(*shape)
        item = torch.empty((), dtype=shape[-1]).element_size()
        assert pipeline.int8kv_smem_bytes(shape[5], item) \
            <= pipeline.MAX_SMEM


def test_every_split_is_a_plan_at_every_width():
    """Every split at every width and dtype, on the one ring of 2 stages
    (the kernel's static_assert: its block fits in 227 KB)."""
    for hd, dtype in itertools.product(PLAN_HD, DTYPES):
        plans = pipeline.int8kv_plans(1, 512, 512, 12, 12, hd, dtype)
        assert plans == [(1, 2), (2, 2), (4, 2)], (hd, dtype)
        item = torch.empty((), dtype=dtype).element_size()
        assert pipeline.int8kv_smem_bytes(hd, item) <= pipeline.MAX_SMEM


def test_int8kv_plan_splits_only_where_sms_idle():
    """A split only where the q tiles alone leave SMs idle; the split grid
    stays within the blocks the SMs hold at once."""
    for B, S, T, H, K, hd, dtype in _plan_shapes():
        split, _ = pipeline.int8kv_plan(B, S, T, H, K, hd, dtype)
        blocks = B * H * -(-S // BLOCK_Q)
        item = torch.empty((), dtype=dtype).element_size()
        if split > 1:
            assert blocks < pipeline.SMS
            assert blocks * split <= pipeline.SMS * \
                pipeline.int8kv_blocks_per_sm(hd, item)
            assert -(-T // block_k(hd)) >= split


def test_int8kv_plans_refuse_what_the_kernel_does_not_take():
    shape = (1, 512, 512, 12, 12, 64, torch.float32)
    for plan in ((3, 2), (8, 2), (2, 1), (2, 3), (2, 4), (0, 2)):
        assert not pipeline.int8kv_plan_legal(plan, *shape)
    assert not pipeline.int8kv_plan_legal((1, 3), 1, 64, 64, 8, 1, 256,
                                          torch.float32)   # no ring of 3
    assert not pipeline.int8kv_plan_legal((1, 2), 1, 64, 64, 2, 2, 320,
                                          torch.float32)   # no width 320


# The rule's picks at chip_smoke.py's ten K6 rows, each measured against
# every plan in chip_smoke.int8kv_sweep_phase (PERF.md §6): the fastest, or
# within the spread of the turns.
K6_PICKS = {
    # (S = T, H, K, hd, dtype): (split, depth)
    (512, 12, 12, 64, torch.float32): (2, 2),
    (64, 12, 12, 64, torch.float32): (1, 2),
    (128, 12, 4, 64, torch.float32): (2, 2),
    (128, 12, 12, 64, torch.float32): (2, 2),
    (512, 12, 12, 64, torch.bfloat16): (2, 2),
    (64, 12, 12, 64, torch.bfloat16): (1, 2),
    (256, 12, 12, 80, torch.float32): (2, 2),
    (256, 12, 12, 96, torch.bfloat16): (2, 2),
    (256, 8, 1, 256, torch.float32): (4, 2),
    (256, 12, 12, 64, torch.float16): (4, 2)}


@pytest.mark.parametrize("key", list(K6_PICKS), ids=str)
def test_int8kv_plan_picks_at_the_swept_shapes(key):
    S, H, K, hd, dtype = key
    assert pipeline.int8kv_plan(1, S, S, H, K, hd, dtype) == K6_PICKS[key]


@pytest.mark.parametrize("sms,split", [(66, 1), (132, 2), (264, 4)])
def test_int8kv_plan_follows_the_card_s_sms(sms, split):
    """The main case's 96 q tiles: no split on a card they fill, 2 on an
    H100's 132 SMs, 4 where twice as many SMs idle."""
    assert pipeline.int8kv_plan(1, 512, 512, 12, 12, 64, torch.float32,
                                sms) == (split, 2)
