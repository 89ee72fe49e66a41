"""The arithmetic of the SSD kernels' chunk step (``csrc/ssd_tile.cuh``)
against the JAX package's ``ssd_scan`` Pallas kernel in interpret mode.

The kernels (K7, K8) run the scan's four products on TF32 tensor cores in
3xTF32: each fp32 operand a is split into hi = tf32(a) (round to nearest,
``cvt.rna``) and lo = a - hi, of which the tensor core reads only the TF32
bits, and a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with fp32
accumulation.  The plain-torch model below does the same: TF32 rounding by
bit masking, the same split, the kernels' chunk, and the products computed
on live causal tiles only (query tile >= key tile; the masked scores are a
select, never an overflowing exp).  It must hold the scan's tolerance
(atol 5e-4 / rtol 1e-3, tests/test_kernels.py:86) at the serving widths in
the "decay" and "strong" input ranges, and one TF32 pass must not: that is
why the kernels split.  Inputs come from numpy seeds; runs in seconds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd_scan import CHUNK

SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
RANGES = {"decay": ((0.1, 0.9), (0.5, 1.5)), "strong": ((3.0, 5.0), (1.5, 2.0))}
TILE_Q, TILE_K = 8, 8   # the kernels' query (n8) and key (k8) tiles


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``; by bit masking."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """The TF32 bits of an fp32 value, as the tensor core reads them."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' tensor cores take it: 3 passes (3xTF32) or 1
    (one TF32 product of the rounded operands); fp32 accumulation."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if passes == 3:
        a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def chunk_step_model(x, dt, A, B, C, chunk: int, passes: int = 3):
    """The kernels' chunked scan: x (BT,H,S,P), dt (BT,H,S), A (H,), B/C
    (BT,S,N), all fp32 → y (BT,H,S,P).  Per chunk: S0 = C B^T on live tiles
    only, M = [k <= q] S0 exp(acum_q - acum_k) dt_k (a select),
    y = exp(acum_q) (C h) + M x over live (query tile, key tile) pairs,
    h <- exp(acum_last) h + B^T (w x); positions past S carry dt = 0."""
    BT, H, S, P = x.shape
    N = B.shape[-1]
    pad = -S % chunk
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, pad))
    B = torch.nn.functional.pad(B, (0, 0, 0, pad))[:, None]
    C = torch.nn.functional.pad(C, (0, 0, 0, pad))[:, None]
    Q = chunk
    h = torch.zeros((BT, H, N, P))
    q_idx = torch.arange(Q)
    causal = q_idx[None, :] <= q_idx[:, None]                 # [q, k]
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, dtc = x[:, :, c0:c0 + Q], dt[:, :, c0:c0 + Q]
        Bc, Cc = B[:, :, c0:c0 + Q], C[:, :, c0:c0 + Q]
        acum = torch.cumsum(dtc * A[None, :, None], dim=-1)
        m = torch.zeros((BT, 1, Q, Q))
        for q0 in range(0, Q, TILE_Q):                        # live tiles
            for k0 in range(0, q0 + TILE_Q, TILE_K):
                m[..., q0:q0 + TILE_Q, k0:k0 + TILE_K] = mm(
                    Cc[..., q0:q0 + TILE_Q, :],
                    Bc[..., k0:k0 + TILE_K, :].transpose(-1, -2), passes)
        diff = acum[..., :, None] - acum[..., None, :]
        decay = torch.exp(torch.where(causal, diff, 0.0))
        m = torch.where(causal, m * decay * dtc[..., None, :], 0.0)
        y = mm(Cc, h, passes) * torch.exp(acum)[..., None]
        for q0 in range(0, Q, TILE_Q):
            for k0 in range(0, q0 + TILE_Q, TILE_K):
                y[..., q0:q0 + TILE_Q, :] += mm(
                    m[..., q0:q0 + TILE_Q, k0:k0 + TILE_K],
                    xc[..., k0:k0 + TILE_K, :], passes)
        last = acum[..., -1:]
        w = torch.exp(last - acum) * dtc
        h = (torch.exp(last)[..., None] * h
             + mm(Bc.transpose(-1, -2), w[..., None] * xc, passes))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S]


def _inputs(kind, BT=1, H=4, S=512, P=64, N=128, seed=0):
    (dt_lo, dt_hi), (a_lo, a_hi) = RANGES[kind]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(BT, H, S, P)).astype(f32),
            rng.uniform(dt_lo, dt_hi, size=(BT, H, S)).astype(f32),
            (-rng.uniform(a_lo, a_hi, size=(H,))).astype(f32),
            rng.normal(size=(BT, S, N)).astype(f32),
            rng.normal(size=(BT, S, N)).astype(f32))


def _jax(arrays):
    return np.asarray(jax_ssd_scan(*[jnp.asarray(a) for a in arrays],
                                   chunk=128, interpret=True))


def _outside(got, want) -> int:
    err = np.abs(got - want)
    return int((err > SCAN_TOL["atol"] + SCAN_TOL["rtol"] * np.abs(want)).sum())


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["decay", "strong"])
def test_3xtf32_chunk_step_holds_the_scan_tolerance(kind, seed):
    arrays = _inputs(kind, seed=seed)
    want = _jax(arrays)
    got = chunk_step_model(*map(torch.from_numpy, arrays), CHUNK).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SCAN_TOL)


def test_one_tf32_pass_falls_outside_the_scan_tolerance():
    arrays = _inputs("decay", seed=1)
    want = _jax(arrays)
    got = chunk_step_model(*map(torch.from_numpy, arrays), CHUNK,
                           passes=1).numpy()
    assert np.isfinite(got).all()
    assert _outside(got, want) > want.size // 100
