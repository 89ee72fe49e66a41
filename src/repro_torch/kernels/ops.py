"""Public kernel routes the model layers call after ``LoweringConfig.lower``
has said ``isax``, and the e-graph evaluator's intrinsics backed by them.

Each route runs the kernel its schedule names — the record's
(``schedule=``), or where none is passed the one ``kernels/schedule.py``
computes for these shapes on the tensors' card: ``flash_attention_gqa``
K2 or K3 (and K3's ring depth), ``int8_matmul`` K4 or K5 (and its plan),
``ssd_scan`` K7 or K8 (and K8's ring depth), ``rmsnorm`` K1 (and its
launch shape).  ``pipelined`` overrides the schedule's choice between the
two kernels of a pair, for tests and sweeps only.  On CPU tensors the
kernel wrappers compute their plain versions; on CUDA tensors a route
launches the kernel the schedule names, or raises.

The kernels have no gradient, as the reference's Pallas kernels cannot be
differentiated (``jax.grad`` through them fails to linearize), and their
launches return tensors autograd has not recorded.  So every route calls
``no_grad_guard`` first: where autograd would record (grad enabled, a
floating input that requires grad) it raises on every device, rather than
return a result cut from the graph.  Training binds backend ``"torch"``.

``kernel_intrinsics`` / ``register_kernel_intrinsics`` bind the routes to
the ``isax:`` e-nodes of ``core/offload.evaluate`` (the port of
``repro/kernels/ops.register_kernel_intrinsics``).  They run the kernels
on the card unless the caller asks for the CPU (``device="cpu"``: the
plain versions, as the reference's compute with its references); with no
CUDA device and no ``device`` they raise (``resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import schedule as ks
from repro_torch.kernels.flash_attention import (DTYPE_CODES, MAX_HEAD_DIM,
                                                 flash_attention)
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_matmul
from repro_torch.kernels.pipeline import (flash_attention_pipelined,
                                          int8_matmul_pipelined, sm_count,
                                          ssd_scan_pipelined)
from repro_torch.kernels.rmsnorm import Plan
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when none is given; raises when that is a
    CUDA device and PyTorch sees none (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def no_grad_guard(route: str, *tensors) -> None:
    """Raise a ``RuntimeError`` where autograd would record through a
    kernel route: grad enabled and a floating input that requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{route}: the hand-written kernels have no gradient (nor do the "
            f"reference's Pallas kernels), so a loss under autograd cannot "
            f"run through them; bind LoweringConfig(\"torch\") to train, or "
            f"call under torch.no_grad()")


def flash_tileable(H: int, K: int, hd: int, dtype) -> bool:
    """True iff the CUDA flash kernels take this head layout and dtype."""
    return H % K == 0 and 1 <= hd <= MAX_HEAD_DIM and dtype in DTYPE_CODES


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def chosen(schedule: dict, pipelined: bool | None) -> dict:
    """The kernel of a pair to run: the schedule's choice, or the one
    ``pipelined`` forces where that kernel has a plan."""
    want = schedule["pipelined"] if pipelined is None else pipelined
    return schedule["pipe"] if want and schedule["pipe"] else schedule["base"]


def flash_attention_gqa(q, k, v, mask, *, sm_scale: float,
                        schedule: dict | None = None,
                        pipelined: bool | None = None):
    """q (B,S,H,hd), k/v (B,T,K,hd), mask (1|B,S,T) bool → (B,S,H,hd):
    K3 at the schedule's ring depth where it says pipelined, else K2."""
    no_grad_guard("flash_attention_gqa", q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if schedule is None:
        schedule = ks.flash_schedule(B, S, H, K, T, hd, q.element_size(),
                                     sm_count(q.device))
    mask = mask.expand(mask.shape[0], S, T).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    run = chosen(schedule, pipelined)
    if run["depth"]:
        return flash_attention_pipelined(q, k, v, mask, sm_scale=sm_scale,
                                         depth=run["depth"])
    return flash_attention(q, k, v, mask, sm_scale=sm_scale)


def int8_matmul(x, wq, scale, *, schedule: dict | None = None,
                pipelined: bool | None = None):
    """Quantized GEMM: x (M,K) fp32/bf16/fp16, wq (N,K) int8, scale (N,)
    fp32 → (x @ f32(wq)ᵀ) · scale[None] in x's dtype: K5 or K4 as the
    schedule says, at its plan.  K5's TMA copies want 16-byte aligned
    operands, so an unaligned one is copied."""
    no_grad_guard("int8_matmul", x, scale)
    M, K = x.shape
    if schedule is None:
        schedule = ks.int8_schedule(M, K, wq.shape[0], x.element_size(),
                                    sm_count(x.device))
    run = chosen(schedule, pipelined)
    if run["kernel"] == "int8_matmul_pipelined":
        return int8_matmul_pipelined(_aligned(x), _aligned(wq),
                                     scale.contiguous(), plan=run["plan"])
    return _int8_matmul(x.contiguous(), wq.contiguous(), scale.contiguous(),
                        plan=run["plan"])


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6,
            schedule: dict | None = None):
    """Row RMSNorm through K1 at the schedule's launch shape: x (R, d), g
    (d,) → (R, d)."""
    no_grad_guard("rmsnorm", x, g)
    x, g = _aligned(x), _aligned(g.float())
    if schedule is None:
        schedule = ks.rmsnorm_schedule(*x.shape, x.element_size(),
                                       sm_count(x.device))
    return _rmsnorm(x, g, eps=eps, shape=Plan(*schedule["plan"]))


def ssd_scan(x, dt, A, B, C, *, schedule: dict | None = None,
             pipelined: bool | None = None):
    """SSD chunked scan: x (BT,H,S,P), dt (BT,H,S), A (H,), B/C (BT,S,N)
    → y (BT,H,S,P) of x's dtype, computed in fp32: K8 at the schedule's
    ring depth where it says pipelined, else K7.  x, dt, B and C share one
    dtype; A is taken in fp32, as the reference widens it."""
    no_grad_guard("ssd_scan", x, dt, A, B, C)
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A.float(), B, C))
    BT, H, S, P = x.shape
    if schedule is None:
        schedule = ks.ssd_schedule(BT, S, H, P, B.shape[-1], x.element_size(),
                                   sm_count(x.device))
    run = chosen(schedule, pipelined)
    if run["depth"]:
        return ssd_scan_pipelined(x, dt, A, B, C, depth=run["depth"])
    return _ssd_scan(x, dt, A, B, C)


# ---------------------------------------------------------------------------
# E-graph intrinsics: the isax: e-nodes of core/offload.evaluate run the
# kernel routes on float32 tensors of ``device``
# ---------------------------------------------------------------------------

def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def kernel_intrinsics(device=None) -> dict:
    """Intrinsics for flash_attention, int8_matvec, ssd_step and rmsnorm
    that compute through the kernel routes on ``device`` (default the
    card; plain versions on the CPU)."""
    device = resolve_device(device)

    def flash(Q, K, V, scale, n_q, P, O):
        q = _t(Q, device)[None, :, None, :]
        k = _t(K, device)[None, :, None, :]
        v = _t(V, device)[None, :, None, :]
        mask = torch.ones((1, q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=device)
        out = flash_attention_gqa(q, k, v, mask, sm_scale=float(scale))
        O[:] = out[0, :, 0, :].cpu().numpy().astype(O.dtype)
        # P (the normalized probabilities) is ISAX-internal; materialize it
        # for evaluator parity with the software program
        s = (np.asarray(Q, np.float64) @ np.asarray(K, np.float64).T) \
            * float(scale)
        e = np.exp(s - s.max(-1, keepdims=True))
        P[:] = e / e.sum(-1, keepdims=True)

    def int8_matvec(Wq, X, s_w, n, C):
        w = _t(Wq, device, torch.int8)
        scale = torch.full((w.shape[0],), float(s_w), dtype=torch.float32,
                           device=device)
        C[:] = int8_matmul(_t(X, device), w, scale).cpu().numpy()

    def ssd(A, B, C, X, T, H, Y):
        # the ISAX's per-step decay a_t is the kernel's exp(dt_t · A_h) with
        # A_h = -1 and dt_t = -log(a_t); the kernel adds dt_t · B_t ⊗ x_t, so
        # x_t is passed divided by dt_t.  The kernel starts from a zero
        # state: an initial state h0 adds C_t · (a_1 ⋯ a_t) h0 to y_t.
        a = np.asarray(A, np.float64)
        dt = -np.log(a)
        xs = np.asarray(X, np.float64) / dt[:, None]
        y = ssd_scan(_t(xs, device)[None, None], _t(dt, device)[None, None],
                     torch.full((1,), -1.0, device=device),
                     _t(B, device)[None], _t(C, device)[None])
        h0 = np.asarray(H[0], np.float64)
        decay = np.cumprod(a)
        Cn = np.asarray(C, np.float64)
        Y[:] = (y[0, 0].cpu().numpy().astype(np.float64)
                + decay[:, None] * (Cn @ h0)).astype(Y.dtype)
        # H (the carried state) is ISAX-internal: materialize its final value
        h = h0
        for t in range(int(T)):
            h = a[t] * h + np.outer(B[t], X[t])
        H[0] = h

    def rms(Xn, G, eps, n, On):
        On[:] = rmsnorm(_t(Xn, device), _t(G, device),
                        eps=float(eps)).cpu().numpy()

    return {"flash_attention": flash, "int8_matvec": int8_matvec,
            "ssd_step": ssd, "rmsnorm": rms}


def register_kernel_intrinsics(device=None) -> None:
    """Register ``kernel_intrinsics(device)`` as the e-graph evaluator's
    overrides (``core.offload.register_intrinsic``)."""
    from repro_torch.core import offload
    for name, fn in kernel_intrinsics(device).items():
        offload.register_intrinsic(name, fn)
