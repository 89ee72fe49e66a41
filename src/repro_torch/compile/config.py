"""``LoweringConfig``: which implementation each hot op of the model runs.

Two backends:

* ``"torch"`` — the plain PyTorch versions everywhere (the counterpart of
  the reference's ``xla`` backend);
* ``"cuda"`` — the hand-written kernels wherever the reference extracts an
  ISAX (the counterpart of ``pallas``).  On CPU tensors the kernel wrappers
  compute their plain versions, so this backend also runs on the CPU.

Until the reference's e-graph dispatch engine is ported, ``lower`` is a
fixed table that reproduces the reference's decisions for the dense ops:

* ``rmsnorm`` → the kernel at every shape;
* ``attention`` / ``attention_decode`` / ``attention_paged`` with S ≥ 8 and
  a head layout the flash kernels take → the flash kernel;
* any of them with S < 8 (a degenerate query tile: decode) → the reference;
* ``matmul`` → the reference (the negative control: no ISAX for a GEMM).
"""

from __future__ import annotations

import dataclasses
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.ops import flash_tileable

VALID_BACKENDS = ("torch", "cuda")
#: Fewest query rows the reference gives a flash kernel (targets/llm.py).
MIN_QUERY_TILE = 8
ATTENTION_OPS = ("attention", "attention_decode", "attention_paged")


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One lowering decision: ``impl`` is ``"isax"`` (the kernel) or
    ``"reference"`` (the plain version); ``note`` says why."""

    impl: str
    note: str


class LoweringConfig:
    """Per-model/engine lowering policy; ``backend`` is ``"torch"`` or
    ``"cuda"`` (the default)."""

    def __init__(self, backend: str = "cuda"):
        if backend not in VALID_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"valid: {VALID_BACKENDS}")
        self.backend = backend

    def __repr__(self):
        return f"LoweringConfig(backend={self.backend!r})"

    def lower(self, op: str, shape, dtype) -> Lowering:
        """The decision for one op instance.

        Shapes follow the reference's keys: ``rmsnorm`` (rows, d);
        attention ops (B, S, H, K, T, hd); ``matmul`` (M, K, N).
        """
        if op == "rmsnorm":
            target = "rmsnorm"
        elif op in ATTENTION_OPS:
            target = "flash_attention"
        elif op == "matmul":
            return Lowering("reference", "no ISAX for a GEMM; torch.matmul")
        else:
            raise ValueError(f"unknown op {op!r}")
        if self.backend == "torch":
            return Lowering("reference", "backend 'torch'")
        if dtype not in DTYPE_CODES:
            return Lowering("reference", f"no {target} kernel for {dtype}")
        if op in ATTENTION_OPS:
            B, S, H, K, T, hd = shape
            if S < MIN_QUERY_TILE:
                return Lowering("reference", f"degenerate query tile (S={S} "
                                             f"< {MIN_QUERY_TILE})")
            if not flash_tileable(H, K, hd, dtype):
                return Lowering("reference", f"untileable shape H={H} K={K} "
                                             f"hd={hd}")
        return Lowering("isax", f"kernel {target}")


def lower(op: str, *, shape, dtype, backend: str = "cuda") -> Lowering:
    """One-shot lowering decision (see ``LoweringConfig.lower``)."""
    return LoweringConfig(backend).lower(op, tuple(int(s) for s in shape),
                                         dtype)
