"""The yardstick's arithmetic: the card's peaks, the least time a kernel's
work can take (its roofline bound), and the model FLOPs a served token
costs.  Frozen here, apart from the program, so that a later change to the
program cannot move the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at 700 W.

Bounds count each input byte read once and each output byte written once,
and the operations the work needs, whatever the kernel does again:

* flash attention (prefill): q, k, v and the output once, the boolean mask
  once; 4·hd operations a live (query, key) pair a head (QKᵀ and PV);
* the SSD scan (K7/K8): x, y, dt, B, C once, A in fp32; 4·H·N·P operations
  a position (one FMA a state element for the update, one for the output),
  at 495/3 TFLOP/s: fp32-accurate products on the TF32 tensor cores take
  three passes (3xTF32), the least that keeps the scan's fp32 accuracy.

Model FLOPs count 2 a multiply-accumulate of every weight a token passes
through, attention's 4·hd a (query, key) pair a head over the keys a token
really attends, and one row of logits a produced token; an embedding
lookup counts none.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12,
              "float16": 989e12}
SSD_FLOPS = PEAK_FLOPS["tfloat32"] / 3
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def bound_s(nbytes: float, ops: float, flops_per_s: float) -> float:
    """The larger of the bytes' time at HBM rate and the ops' at the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / flops_per_s)


def causal_pairs(S: int, T: int) -> int:
    """Live (query, key) pairs of a causal (S, T) mask whose diagonal ends
    at the last key."""
    off = T - S
    return sum(min(T, i + off + 1) for i in range(S))


def flash_bound_s(B: int, S: int, T: int, H: int, K: int, hd: int,
                  dtype: str, live_pairs: int, mask_bytes: int) -> float:
    """Least time of one prefill attention call: q (B,S,H,hd), k/v
    (B,T,K,hd), out (B,S,H,hd), the mask, and ``live_pairs`` pairs a
    (batch, head)."""
    nbytes = (2 * B * S * H + 2 * B * T * K) * hd * ITEMSIZE[dtype] \
        + mask_bytes
    ops = 4 * hd * H * B * live_pairs
    return bound_s(nbytes, ops, PEAK_FLOPS[dtype])


def ssd_bound_s(BT: int, H: int, S: int, P: int, N: int,
                itemsize: int) -> float:
    """Least time of one SSD scan call: x (BT,H,S,P) in, y out, dt
    (BT,H,S), B/C (BT,S,N), A (H,) fp32."""
    nbytes = itemsize * (2 * BT * H * S * P + BT * H * S + 2 * BT * S * N) \
        + 4 * H
    ops = 4 * BT * H * S * N * P
    return bound_s(nbytes, ops, SSD_FLOPS)


# -- model FLOPs ---------------------------------------------------------------

def dense_linear_flops(m: dict) -> float:
    """2 × the block weights a token passes through (q, k, v, o, SwiGLU)."""
    d, L, H, K = m["d_model"], m["n_layers"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // H
    return 2.0 * L * (d * hd * (2 * H + 2 * K) + 3 * d * m["d_ff"])


def attn_flops(m: dict, keys: float) -> float:
    """QKᵀ and PV of one query over ``keys`` keys, every layer."""
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return 4.0 * m["n_layers"] * m["n_heads"] * hd * keys


def logits_flops(m: dict) -> float:
    """One row of logits."""
    return 2.0 * m["d_model"] * m["vocab"]


def dense_prefill_flops(m: dict, n: int) -> float:
    """A causal prefill of ``n`` real tokens and its one row of logits."""
    return (n * dense_linear_flops(m) + attn_flops(m, n * (n + 1) / 2)
            + logits_flops(m))


def ssm_dims(m: dict) -> tuple[int, int, int, int, int]:
    """(d_in, H, N, P, conv width) of a Mamba-2 block."""
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    return d_in, d_in // s["head_dim"], s["d_state"], s["head_dim"], \
        s["conv_width"]


def ssm_token_flops(m: dict) -> float:
    """One token through every Mamba-2 block: in/out projections, the
    depthwise conv, and the scan's least (4·H·N·P)."""
    d = m["d_model"]
    d_in, H, N, P, w = ssm_dims(m)
    per = (2 * d * (2 * d_in + 2 * N + H) + 2 * d_in * d
           + 2 * w * (d_in + 2 * N) + 4 * H * N * P)
    return float(m["n_layers"] * per)


def ssm_prefill_flops(m: dict, n: int) -> float:
    """A prefill of ``n`` tokens and its one row of logits."""
    return n * ssm_token_flops(m) + logits_flops(m)
