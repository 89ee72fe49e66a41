"""Plain fp32 references of the benchmark's models, in plain PyTorch.

They import nothing of the program, take the benchmark's own weights and
the prompts and served tokens, and work every cache and state out again
from those.  Matrix products run in full fp32 (TF32 off, set by
``fp32_matmul``).  ``quant="fp8"`` rounds every product's operands to
float8 e4m3 (a per-tensor scale, fp32 accumulation): the control that a
lower precision than the configuration's bf16 has to fail.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_matmul():
    """TF32 off for matmuls and convolutions, restored on leaving."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_quant(x: torch.Tensor, quant) -> torch.Tensor:
    """``x`` (fp32) rounded to float8 e4m3 under one per-tensor scale and
    widened back; ``x`` itself when ``quant`` is None."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quantisation {quant!r}")
    scale = torch.clamp(x.abs().amax(), min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, quant=None) -> torch.Tensor:
    """``a @ b`` in fp32, operands through ``fake_quant``."""
    return fake_quant(a, quant) @ fake_quant(b, quant)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()
