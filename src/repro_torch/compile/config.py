"""``LoweringConfig``: which implementation each hot op of the model runs.

Two backends:

* ``"torch"`` — the plain PyTorch versions everywhere (the counterpart of
  the reference's ``xla`` backend);
* ``"cuda"`` — the hand-written kernels wherever the reference extracts an
  ISAX (the counterpart of ``pallas``).  On CPU tensors the kernel wrappers
  compute their plain versions, so this backend also runs on the CPU.

Until the reference's e-graph dispatch engine is ported, ``lower`` is a
fixed table that reproduces the reference's decisions for the dense, the
SSM and the point-cloud ops:

Every kernel takes fp32, bf16 and fp16, as the reference's do:

* ``rmsnorm`` → the kernel at every shape;
* ``attention`` / ``attention_decode`` / ``attention_paged`` with S ≥ 8 →
  the flash kernel, for H a multiple of K and any head dim up to 256 (the
  widest instantiation); a head dim above 256 takes the reference, a
  stated deviation (the reference's kernel takes any);
* any of them with S < 8 (a degenerate query tile: decode) → the reference;
* ``matmul`` → the reference (the negative control: no ISAX for a GEMM);
* ``int8_matmul`` (M, K, N) → the kernel at every shape (the reference's
  ``down_pow2`` always finds a dividing tile; the port's kernels take any
  M, N, K);
* ``ssd_scan`` → the kernel at every sequence length (the reference rounds
  its chunk down to a power of two that divides S; the port's kernels take
  any S) and at any P and N whose (N, P) fp32 state and chunk fit one
  block's shared memory (``ssd_tileable``; P = N = 256 does not);
* ``fps`` → the kernel unless asked for more samples than points;
* ``ball_query`` / ``group_aggregate`` → the kernel unless the reference
  cannot tile the shape (``pointcloud.ops.tileable``).

The point-cloud fallbacks are ``pointcloud.ops.fallback``, which the
point-cloud entry points read too; where ``lower`` says ``isax`` the
``LoweringConfig`` methods call the kernel routes directly.

The reference also sends FPS to its plain version when the cloud exceeds
the TPU's VMEM; the port's FPS kernel has no such ceiling.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.kernels.flash_attention import DTYPE_CODES as FLASH_DTYPES
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM
from repro_torch.kernels.int8_matmul import DTYPE_CODES as INT8_DTYPES
from repro_torch.kernels.ops import flash_tileable
from repro_torch.kernels.rmsnorm import DTYPE_CODES as RMSNORM_DTYPES
from repro_torch.kernels.ssd_scan import DTYPE_CODES as SSD_DTYPES
from repro_torch.kernels.ssd_scan import ssd_tileable
from repro_torch.pointcloud import ops as pc_ops
from repro_torch.pointcloud import ref as pc_ref

VALID_BACKENDS = ("torch", "cuda")
#: Fewest query rows the reference gives a flash kernel (targets/llm.py).
MIN_QUERY_TILE = 8
ATTENTION_OPS = ("attention", "attention_decode", "attention_paged")
POINTCLOUD_TARGETS = {"fps": "fps", "ball_query": "ball_query",
                      "group_aggregate": "group_agg"}
#: Activation dtypes each op's kernels take (the point-cloud kernels share
#: the flash kernels' codes).
KERNEL_DTYPES = {"rmsnorm": RMSNORM_DTYPES, "int8_matmul": INT8_DTYPES,
                 "ssd_scan": SSD_DTYPES,
                 **{op: FLASH_DTYPES for op in (*ATTENTION_OPS,
                                                *POINTCLOUD_TARGETS)}}


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
        # int8_matmul's lowering by (M, K, N, dtype): the decision is fixed
        # for a shape, and the entry point is called once a projection
        self._int8_isax: dict = {}

    def __repr__(self):
        return f"LoweringConfig(backend={self.backend!r})"

    def lower(self, op: str, shape, dtype) -> Lowering:
        """The decision for one op instance.

        Shapes follow the reference's keys: ``rmsnorm`` (rows, d);
        attention ops (B, S, H, K, T, hd); ``matmul`` and ``int8_matmul``
        (M, K, N); ``fps``
        (B, N, S); ``ball_query`` (B, N, M, k); ``group_aggregate``
        (B, N, M, k, C); ``ssd_scan`` (b, s, H, P, N).
        """
        if op == "rmsnorm":
            target = "rmsnorm"
        elif op in ATTENTION_OPS:
            target = "flash_attention"
        elif op in POINTCLOUD_TARGETS:
            target = POINTCLOUD_TARGETS[op]
        elif op in ("ssd_scan", "int8_matmul"):
            target = op
        elif op == "matmul":
            return Lowering("reference", "no ISAX for a GEMM; torch.matmul")
        else:
            raise ValueError(f"unknown op {op!r}")
        if self.backend == "torch":
            return Lowering("reference", "backend 'torch'")
        if dtype not in KERNEL_DTYPES[op]:
            return Lowering("reference", f"no {target} kernel for {dtype}")
        if op == "ssd_scan" and not ssd_tileable(shape[3], shape[4]):
            return Lowering("reference", f"state P={shape[3]} N={shape[4]} "
                                         f"does not fit one block's shared "
                                         f"memory")
        if op in ATTENTION_OPS:
            B, S, H, K, T, hd = shape
            if S < MIN_QUERY_TILE:
                return Lowering("reference", f"degenerate query tile (S={S} "
                                             f"< {MIN_QUERY_TILE})")
            if hd > MAX_HEAD_DIM:
                return Lowering("reference", f"head dim {hd} > "
                                             f"{MAX_HEAD_DIM}, the widest "
                                             f"flash kernel")
            if not flash_tileable(H, K, hd, dtype):
                return Lowering("reference", f"untileable shape H={H} K={K} "
                                             f"hd={hd}")
        if op in POINTCLOUD_TARGETS:
            reason = pc_ops.fallback(op, shape)
            if reason:
                return Lowering("reference", reason)
        return Lowering("isax", f"kernel {target}")

    # -- standalone op entry points (ops with no model host function) -----

    def int8_matmul(self, x, wq, scale):
        """Quantized GEMM: x (M,K) float, wq (N,K) int8, scale (N,) fp32 →
        (M,N) of x's dtype; K4/K5 where ``lower`` says ``isax`` (routed by
        ``kernels.ops.int8_matmul``), the plain version where it says
        ``reference``."""
        key = (*x.shape, wq.shape[0], x.dtype)
        isax = self._int8_isax.get(key)
        if isax is None:
            isax = self._int8_isax[key] = self.lower(
                "int8_matmul", key[:3], x.dtype).impl == "isax"
        if isax:
            return kernel_ops.int8_matmul(x, wq, scale)
        return kernel_ref.int8_matmul_ref(x, wq, scale)

    # -- point-cloud vertical (fps → ball_query → group_aggregate) ---------
    # ``pipelined`` overrides the baseline/pipelined choice where the
    # kernel runs (None: the port's rule, ``kernels.pipeline.use_pipeline``).

    def fps(self, xyz, n_samples: int):
        """Farthest-point sampling: xyz (B,N,3) → indices (B,n_samples) i32."""
        B, N, _ = xyz.shape
        if self.lower("fps", (B, N, n_samples), xyz.dtype).impl == "isax":
            return pc_ops.kernel_fps(xyz, n_samples)
        return pc_ref.fps_ref(xyz, n_samples)

    def ball_query(self, xyz, centers, radius: float, k: int, *,
                   pipelined: bool | None = None):
        """Ball-query grouping: xyz (B,N,3), centers (B,M,3) → neighbour
        indices (B,M,k) i32."""
        B, N, _ = xyz.shape
        M = centers.shape[1]
        if self.lower("ball_query", (B, N, M, k), xyz.dtype).impl == "isax":
            return pc_ops.kernel_ball_query(xyz, centers, radius, k,
                                            pipelined=pipelined)
        return pc_ref.ball_query_ref(xyz, centers, radius, k)

    def group_aggregate(self, features, idx, *, pipelined: bool | None = None):
        """Grouped aggregation: features (B,N,C), idx (B,M,k) → max-pooled
        (B,M,C)."""
        B, N, C = features.shape
        M, k = idx.shape[1], idx.shape[2]
        if self.lower("group_aggregate", (B, N, M, k, C),
                      features.dtype).impl == "isax":
            return pc_ops.kernel_group_aggregate(features, idx,
                                                 pipelined=pipelined)
        return pc_ref.group_aggregate_ref(features, idx)


def lower(op: str, *, shape, dtype, backend: str = "cuda") -> Lowering:
    """One-shot lowering decision (see ``LoweringConfig.lower``)."""
    return LoweringConfig(backend).lower(op, tuple(int(s) for s in shape),
                                         dtype)
