"""The LLM domain package: every ISAX the language-model vertical ships.

The port of ``repro/targets/llm.py``.  The divergent software trace
programs, the ISAX skeleton/component definitions and the numpy evaluator
semantics are the reference's, copied; the kernels are the port's routes
(``kernels/ops.py``, ``kernels/pipeline.py``), and the schedulers return
the H100 schedule of ``kernels/schedule.py`` — or ``(None, why)`` where
the port's kernels stop short of the reference's (a head dim above 256,
an SSD state that does not fit one block) or the reference itself keeps
the plain version (a query of fewer than 8 rows).  Registered by
``repro_torch.targets`` at import time; the generic dispatch engine never
names any of it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.expr import Term, arr, const, for_, var
from repro_torch.core.matching import ISAX
from repro_torch.core.tiling import dtype_itemsize
from repro_torch.kernels import ops as kops
from repro_torch.kernels import schedule as ks
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM
from repro_torch.kernels.pipeline import (current_sm_count,
                                          flash_attention_pipelined,
                                          int8_matmul_pipelined,
                                          ssd_scan_pipelined)
from repro_torch.kernels.ssd_scan import ssd_tileable
from repro_torch.targets.registry import ChunkedLowering, DomainPackage, IsaxSpec

if TYPE_CHECKING:
    from repro_torch.compile.trace import OpKey

#: Minimum query rows for the flash ISAX: the row-blocked skeleton needs at
#: least one sublane-worth of rows; single-token decode tiles degenerate.
MIN_QUERY_TILE = 8
#: Activation dtypes every kernel of the port takes.
KERNEL_DTYPES = ("float32", "bfloat16", "float16")


# ---------------------------------------------------------------------------
# Trace programs — the *software-side* spellings, deliberately divergent
# from the ISAX semantics so matching is a saturation theorem, not string
# equality (the paper's retargetability claim).
# ---------------------------------------------------------------------------

def _attention_program() -> Term:
    """Row-blocked attention, AF+RF-divergent: the scale rides inside the
    matvec and the softmax omits the max shift (the bench's robustness
    variant) — internal rewrites must recover the flash ISAX form."""
    i = var("i")
    q = ("load", arr("Q"), i)
    s = ("/",
         ("exp", ("matvec", arr("K"), ("*", var("scale"), q))),
         ("rowsum", ("exp", ("matvec", arr("K"), ("*", var("scale"), q)))))
    return for_("i", const(0), var("n_q"), const(1),
                ("store", arr("P"), i, s),
                ("store", arr("O"), i,
                 ("matvec", ("transpose", arr("V")), ("load", arr("P"), i))))


def _rmsnorm_program() -> Term:
    """RMSNorm with rsqrt spelled as recip∘sqrt (RF-divergent)."""
    i = var("i")
    x = ("load", arr("Xn"), i)
    return for_("i", const(0), var("n"), const(1),
                ("store", arr("On"), i,
                 ("*", ("*", x, ("recip", ("sqrt",
                                           ("+", ("rowmean", ("*", x, x)),
                                            var("eps"))))),
                  arr("G"))))


def _matmul_program() -> Term:
    """Plain row-wise matmul — no quantization scale, so it must NOT match
    the int8_matvec ISAX (the library has no bf16 GEMM datapath)."""
    i = var("i")
    return for_("i", const(0), var("n"), const(1),
                ("store", arr("C"), i,
                 ("matvec", arr("W"), ("load", arr("X"), i))))


def _int8_matmul_program() -> Term:
    i = var("i")
    return for_("i", const(0), var("n"), const(1),
                ("store", arr("C"), i,
                 ("*", var("s_w"),
                  ("matvec", arr("Wq"), ("load", arr("X"), i)))))


def _ssd_program() -> Term:
    """SSD recurrence with the loop-carried state dependence through H."""
    t = var("t")
    upd = ("+",
           ("*", ("load", arr("A"), t), ("load", arr("H"), const(0))),
           ("outer", ("load", arr("B"), t), ("load", arr("X"), t)))
    out = ("matvec", ("transpose", ("load", arr("H"), const(0))),
           ("load", arr("C"), t))
    return for_("t", const(0), var("T"), const(1),
                ("store", arr("H"), const(0), upd),
                ("store", arr("Y"), t, out))


# ---------------------------------------------------------------------------
# ISAX definitions: the specialized datapaths this "ASIP" ships (§6
# analogues), written in the same mini-IR as software (§5.1).
# ---------------------------------------------------------------------------

def isax_flash_attention() -> ISAX:
    """Row-blocked attention: for each query row i, S[i] = softmax-numerator,
    O[i] = normalized PV product.  Two components under two store anchors in
    a single-loop skeleton (the paper's Figure 5 shape, adapted)."""
    i = var("i")
    q_row = ("load", arr("Q"), i)
    s_row = ("/",
             ("exp", ("-", ("*", var("scale"), ("matvec", arr("K"), q_row)),
                      ("rowmax", ("*", var("scale"),
                                  ("matvec", arr("K"), q_row))))),
             ("rowsum", ("exp", ("-", ("*", var("scale"),
                                       ("matvec", arr("K"), q_row)),
                                 ("rowmax", ("*", var("scale"),
                                             ("matvec", arr("K"), q_row)))))))
    body_s = ("store", arr("P"), i, s_row)
    body_o = ("store", arr("O"), i,
              ("matvec", ("transpose", arr("V")), ("load", arr("P"), i)))
    term = for_("i", const(0), var("n_q"), const(1), body_s, body_o)
    return ISAX(
        name="flash_attention",
        params=("Q", "K", "V", "scale", "n_q", "P", "O"),
        term=term,
        kernel="flash_attention",
        outputs=("P", "O"),
    )


def isax_int8_matvec() -> ISAX:
    """Quantized GEMV: C[i] = s_w * (Wq @ x[i]) — the LLM-inference ISAX
    (paper §6.5 uses 8-bit quantized Llama attention/FFN)."""
    i = var("i")
    term = for_("i", const(0), var("n"), const(1),
                ("store", arr("C"), i,
                 ("*", var("s_w"),
                  ("matvec", arr("Wq"), ("load", arr("X"), i)))))
    return ISAX(
        name="int8_matvec",
        params=("Wq", "X", "s_w", "n", "C"),
        term=term,
        kernel="int8_matmul",
        outputs=("C",),
    )


def isax_ssd_step() -> ISAX:
    """SSD (state-space duality) recurrence: H ← a_t·H + B_t⊗x_t;
    y_t = H^T·C_t.  Loop-carried dependence through H (tests the §5.4
    loop-carried check)."""
    t = var("t")
    upd = ("+",
           ("*", ("load", arr("A"), t), ("load", arr("H"), const(0))),
           ("outer", ("load", arr("B"), t), ("load", arr("X"), t)))
    out = ("matvec", ("transpose", ("load", arr("H"), const(0))),
           ("load", arr("C"), t))
    term = for_("t", const(0), var("T"), const(1),
                ("store", arr("H"), const(0), upd),
                ("store", arr("Y"), t, out))
    return ISAX(
        name="ssd_step",
        params=("A", "B", "C", "X", "T", "H", "Y"),
        term=term,
        kernel="ssd_scan",
        outputs=("H", "Y"),
    )


def isax_rmsnorm() -> ISAX:
    """Fused RMSNorm row op: O[i] = x * rsqrt(mean(x²) + eps) * g."""
    i = var("i")
    x = ("load", arr("Xn"), i)
    term = for_("i", const(0), var("n"), const(1),
                ("store", arr("On"), i,
                 ("*", ("*", x, ("rsqrt",
                                 ("+", ("rowmean", ("*", x, x)),
                                  var("eps")))),
                  arr("G"))))
    return ISAX(
        name="rmsnorm",
        params=("Xn", "G", "eps", "n", "On"),
        term=term,
        kernel="rmsnorm",
        outputs=("On",),
    )


def isax_swiglu() -> ISAX:
    """Fused SwiGLU MLP row op: O[i] = ((Wg·x)·σ(Wg·x) ⊙ (Wu·x))ᵀ·Wo —
    written with silu expanded to its x·sigmoid(x) = x/(1+exp(−x)) form so
    software variants using either spelling match."""
    i = var("i")
    x = ("load", arr("Xs"), i)
    g = ("matvec", arr("Wg"), x)
    u = ("matvec", arr("Wu"), x)
    silu_g = ("/", g, ("+", ("const:1",), ("exp", ("neg", g))))
    term = for_("i", const(0), var("n"), const(1),
                ("store", arr("Os"), i,
                 ("matvec", ("transpose", arr("Wo")),
                  ("*", silu_g, u))))
    return ISAX(
        name="swiglu",
        params=("Wg", "Wu", "Wo", "Xs", "n", "Os"),
        term=term,
        kernel="swiglu",
        outputs=("Os",),
    )


# ---------------------------------------------------------------------------
# Evaluator semantics (numpy oracles the e-graph evaluator binds;
# kernels/ops.kernel_intrinsics replaces them with the kernel routes)
# ---------------------------------------------------------------------------

def _np_flash_attention(Q, K, V, scale, n_q, P, O):
    S = (Q @ K.T) * scale
    Pm = np.exp(S - S.max(axis=-1, keepdims=True))
    P[:] = Pm / Pm.sum(axis=-1, keepdims=True)
    O[:] = P @ V


def _np_int8_matvec(Wq, X, s_w, n, C):
    C[:] = (X @ Wq.astype(np.float64).T) * s_w


def _np_ssd_scan(A, B, C, X, T, H, Y):
    h = H[0]
    for t in range(int(T)):
        h = A[t] * h + np.outer(B[t], X[t])
        Y[t] = h.T @ C[t]
    H[0] = h


def _np_rmsnorm(Xn, G, eps, n, On):
    ms = np.mean(Xn * Xn, axis=-1, keepdims=True)
    On[:] = Xn / np.sqrt(ms + eps) * G


def _np_swiglu(Wg, Wu, Wo, Xs, n, Os):
    g = Xs @ Wg.T
    u = Xs @ Wu.T
    Os[:] = (g / (1.0 + np.exp(-g)) * u) @ Wo


# ---------------------------------------------------------------------------
# Schedulers: OpKey → (the H100 schedule, "ok") or (None, why-not)
# ---------------------------------------------------------------------------

def _no_kernel(key: "OpKey", target: str):
    """Why no kernel takes this key's dtype, or None."""
    if key.dtype not in KERNEL_DTYPES:
        return f"no {target} kernel for {key.dtype}"
    return None


def _attention_schedule(key: "OpKey"):
    B, S, H, K, T, hd = key.shape
    if S < MIN_QUERY_TILE:
        return None, f"degenerate query tile (S={S} < {MIN_QUERY_TILE})"
    if hd > MAX_HEAD_DIM:
        return None, f"head dim {hd} > {MAX_HEAD_DIM}, the widest flash kernel"
    if H % K:
        return None, f"untileable shape H={H} K={K} hd={hd}"
    why = _no_kernel(key, "flash_attention")
    if why:
        return None, why
    return ks.flash_schedule(B, S, H, K, T, hd, dtype_itemsize(key.dtype),
                             current_sm_count()), "ok"


def _rmsnorm_schedule(key: "OpKey"):
    rows, d = key.shape
    why = _no_kernel(key, "rmsnorm")
    if why:
        return None, why
    return ks.rmsnorm_schedule(rows, d, dtype_itemsize(key.dtype),
                               current_sm_count()), "ok"


def _int8_matmul_schedule(key: "OpKey"):
    M, Kd, N = key.shape
    why = _no_kernel(key, "int8_matvec")
    if why:
        return None, why
    return ks.int8_schedule(M, Kd, N, dtype_itemsize(key.dtype),
                            current_sm_count()), "ok"


def _ssd_schedule(key: "OpKey"):
    b, s, H, P, N = key.shape
    if not ssd_tileable(P, N):
        return None, (f"state P={P} N={N} does not fit one block's shared "
                      f"memory")
    why = _no_kernel(key, "ssd_step")
    if why:
        return None, why
    return ks.ssd_schedule(b, s, H, P, N, dtype_itemsize(key.dtype),
                           current_sm_count()), "ok"


# ---------------------------------------------------------------------------
# The domain package
# ---------------------------------------------------------------------------

_ATTN_CHUNKED = ChunkedLowering(
    axis=1,
    note="online-softmax attention over key chunks (torch)",
    fallback_note="single-row query; plain version")

DOMAIN = DomainPackage(
    name="llm",
    description="Language-model serving/training hot ops (attention, "
                "RMSNorm, quantized GEMM, SSD scan, SwiGLU).",
    specs=(
        IsaxSpec(
            name="flash_attention",
            isax=isax_flash_attention,
            evaluator=_np_flash_attention,
            trace_kind="attention",
            trace_program=_attention_program,
            ops=("attention", "attention_decode", "attention_paged"),
            rewrites=("softmax-shift", "matvec-scale-right"),
            scheduler=_attention_schedule,
            kernel=kops.flash_attention_gqa,
            kernel_pipelined=flash_attention_pipelined,
            chunked=_ATTN_CHUNKED,
            op_notes=(("attention", "prefill"),
                      ("attention_decode", "1-row query → reference"),
                      ("attention_paged", "1-row query → reference")),
            description="Row-blocked GQA flash attention.",
        ),
        IsaxSpec(
            name="int8_matvec",
            isax=isax_int8_matvec,
            evaluator=_np_int8_matvec,
            trace_kind="int8_matmul",
            trace_program=_int8_matmul_program,
            ops=("int8_matmul",),
            scheduler=_int8_matmul_schedule,
            kernel=kops.int8_matmul,
            kernel_pipelined=int8_matmul_pipelined,
            description="Quantized GEMV/GEMM with per-channel dequant.",
        ),
        IsaxSpec(
            name="ssd_step",
            isax=isax_ssd_step,
            evaluator=_np_ssd_scan,
            trace_kind="ssd_scan",
            trace_program=_ssd_program,
            ops=("ssd_scan",),
            scheduler=_ssd_schedule,
            kernel=kops.ssd_scan,
            kernel_pipelined=ssd_scan_pipelined,
            description="Mamba2 SSD chunked scan (loop-carried state).",
        ),
        IsaxSpec(
            name="rmsnorm",
            isax=isax_rmsnorm,
            evaluator=_np_rmsnorm,
            trace_kind="rmsnorm",
            trace_program=_rmsnorm_program,
            ops=("rmsnorm",),
            rewrites=("rsqrt-form",),
            scheduler=_rmsnorm_schedule,
            kernel=kops.rmsnorm,
            description="Row-blocked fused RMSNorm.",
        ),
        IsaxSpec(
            name="swiglu",
            isax=isax_swiglu,
            evaluator=_np_swiglu,
            rewrites=("div-as-recip-mul",),
            description="Fused SwiGLU MLP row op (library-only: no "
                        "dispatch key yet).",
        ),
        IsaxSpec(
            name="matmul",
            trace_kind="matmul",
            trace_program=_matmul_program,
            ops=("matmul",),
            op_notes=(("matmul", "negative control — no bf16 GEMM "
                                 "datapath exists"),),
            description="Plain bf16/fp32 matmul: deliberate negative "
                        "control that must lower to torch.matmul.",
        ),
    ),
)
