"""``LoweringConfig``: the backend/dispatch handle threaded through models
and engines.

Backends (the reference's in brackets):

* ``"torch"`` (``xla``) — the plain PyTorch versions everywhere;
* ``"torch_chunked"`` (``xla_chunked``) — the attention family's online
  softmax over key chunks in plain torch ops (``layers._sdpa_chunked``);
* ``"cuda"`` (``pallas``, the default) — the hand-written kernels wherever
  the e-graph engine extracts an ISAX and the op's scheduler takes the
  shape.  On CPU tensors the kernel routes compute their plain versions,
  so this backend also runs on the CPU.

The backend states a preference; the dispatcher (``compile/dispatch.py``)
decides per (op, shape, dtype) whether the e-graph pipeline matched the
op's ISAX and what the H100 schedule is, and records it.  The environment
(``REPRO_ATTENTION_IMPL``, else ``REPRO_BACKEND``) is read in exactly one
place — this constructor — and only when no backend is given; it may name
a port backend or the reference's (``xla`` → torch, ``xla_chunked`` →
torch_chunked, ``pallas`` and ``pallas_interpret`` → cuda).

Deviations from the reference, stated by the schedulers as ``(None,
why)``: a head dim above 256 (the widest flash kernel) and an SSD state
that does not fit one block's shared memory take the plain version; FPS
has no capacity ceiling (the reference's VMEM fallback does not apply).
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.compile.dispatch import (CompileRecord, Dispatcher,
                                          get_dispatcher)
from repro_torch.kernels import ref as kernel_ref
from repro_torch.pointcloud import ref as pc_ref
from repro_torch.targets.registry import TargetRegistry

VALID_BACKENDS = ("torch", "torch_chunked", "cuda")

#: First env var set wins; read only by the LoweringConfig constructor.
_ENV_VARS = ("REPRO_ATTENTION_IMPL", "REPRO_BACKEND")
#: The reference's backend names, as the environment may give them.
_REFERENCE_NAMES = {"xla": "torch", "xla_chunked": "torch_chunked",
                    "pallas": "cuda", "pallas_interpret": "cuda"}


#: dtype (a ``torch.dtype`` or its name) → the name a key carries
_DTYPE_NAMES: dict = {}


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32``, ``"float32"`` itself, ... (the
    name a compile-cache key carries, as the reference's keys do)."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).removeprefix("torch.")
    return name


class LoweringConfig:
    """Per-model/engine lowering policy over the compile cache."""

    def __init__(self, backend: Optional[str] = None,
                 dispatcher: Optional[Dispatcher] = None):
        if backend is None:
            for name in _ENV_VARS:
                backend = os.environ.get(name)
                if backend:
                    break
            backend = _REFERENCE_NAMES.get(backend, backend) or "cuda"
        if backend not in VALID_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"valid: {VALID_BACKENDS}")
        self.backend = backend
        self.dispatcher = dispatcher or get_dispatcher()

    @classmethod
    def from_registry(cls, backend: Optional[str] = None, *,
                      registry: Optional[TargetRegistry] = None,
                      dispatcher: Optional[Dispatcher] = None
                      ) -> "LoweringConfig":
        """Build a lowering policy over an ISAX/domain registry: the global
        one through the process-wide cache by default; ``registry=`` an
        isolated one with a fresh cache; ``dispatcher=`` a given cache."""
        if dispatcher is None:
            dispatcher = (Dispatcher(registry) if registry is not None
                          else get_dispatcher())
        elif registry is not None and dispatcher.registry is not registry:
            raise ValueError("pass either registry= or dispatcher=, not "
                             "disagreeing both")
        return cls(backend=backend, dispatcher=dispatcher)

    @property
    def registry(self) -> TargetRegistry:
        """The ISAX/domain registry this policy dispatches against."""
        return self.dispatcher.registry

    def __repr__(self):
        return f"LoweringConfig(backend={self.backend!r})"

    def lower(self, op: str, shape, dtype) -> CompileRecord:
        """The compile-cache record for one op instance.

        Shapes follow the reference's keys: ``rmsnorm`` (rows, d);
        attention ops (B, S, H, K, T, hd); ``matmul`` and ``int8_matmul``
        (M, K, N); ``ssd_scan`` (b, s, H, P, N); ``fps`` (B, N, S);
        ``ball_query`` (B, N, M, k); ``group_aggregate`` (B, N, M, k, C).
        ``dtype`` is a ``torch.dtype`` or its name.  A repeated lookup is
        one probe of the dispatcher's records with the raw key tuple."""
        return self.dispatcher.lower(
            (op, shape if type(shape) is tuple else tuple(shape),
             dtype_name(dtype), self.backend))

    # -- standalone op entry points (ops with no model host function) -----

    def int8_matmul(self, x, wq, scale):
        """Quantized GEMM: x (M,K) fp32/bf16/fp16, wq (N,K) int8, scale (N,)
        fp32 → (M,N) of x's dtype: K4 or K5 as the record's schedule says
        where ``lower`` says ``isax``, else the plain version."""
        M, K = x.shape
        rec = self.lower("int8_matmul", (M, K, wq.shape[0]), x.dtype)
        if rec.impl == "isax":
            return rec.kernel_fn(x, wq, scale, schedule=rec.schedule)
        return kernel_ref.int8_matmul_ref(x, wq, scale)

    # -- point-cloud vertical (fps → ball_query → group_aggregate) ---------
    # ``pipelined`` overrides the record's baseline/pipelined choice where
    # the kernel runs (for tests and sweeps only).

    def fps(self, xyz, n_samples: int):
        """Farthest-point sampling: xyz (B,N,3) → indices (B,n_samples) i32."""
        B, N, _ = xyz.shape
        rec = self.lower("fps", (B, N, n_samples), xyz.dtype)
        if rec.impl == "isax":
            return rec.kernel_fn(xyz, n_samples)
        return pc_ref.fps_ref(xyz, n_samples)

    def ball_query(self, xyz, centers, radius: float, k: int, *,
                   pipelined: bool | None = None):
        """Ball-query grouping: xyz (B,N,3), centers (B,M,3) → neighbour
        indices (B,M,k) i32."""
        B, N, _ = xyz.shape
        M = centers.shape[1]
        rec = self.lower("ball_query", (B, N, M, k), xyz.dtype)
        if rec.impl == "isax":
            return rec.kernel_fn(xyz, centers, radius, k,
                                 schedule=rec.schedule, pipelined=pipelined)
        return pc_ref.ball_query_ref(xyz, centers, radius, k)

    def group_aggregate(self, features, idx, *, pipelined: bool | None = None):
        """Grouped aggregation: features (B,N,C), idx (B,M,k) → max-pooled
        (B,M,C)."""
        B, N, C = features.shape
        M, k = idx.shape[1], idx.shape[2]
        rec = self.lower("group_aggregate", (B, N, M, k, C), features.dtype)
        if rec.impl == "isax":
            return rec.kernel_fn(features, idx, schedule=rec.schedule,
                                 pipelined=pipelined)
        return pc_ref.group_aggregate_ref(features, idx)


# ---------------------------------------------------------------------------
# Process default (what model functions use when no LoweringConfig is
# threaded in)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[LoweringConfig] = None


def default_lowering() -> LoweringConfig:
    """The process-default LoweringConfig (created lazily from the env,
    bound to the global registry)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = LoweringConfig.from_registry()
    return _DEFAULT


def lower(op: str, *, shape, dtype, backend: Optional[str] = None
          ) -> CompileRecord:
    """Public one-shot lowering through the process-default policy's
    compile cache; an explicit ``backend`` reuses that policy's dispatcher
    (its registry and cache)."""
    dflt = default_lowering()
    if backend is None:
        return dflt.lower(op, shape, dtype)
    return LoweringConfig(backend=backend,
                          dispatcher=dflt.dispatcher).lower(op, shape, dtype)


def set_default_lowering(lowering: LoweringConfig) -> Optional[LoweringConfig]:
    """Install a new process-default; returns the prior one (for restore)."""
    global _DEFAULT
    prior = _DEFAULT
    _DEFAULT = lowering
    return prior


def set_default_backend(backend: str) -> str:
    """Swap the default backend, returning the prior backend name."""
    prior = default_lowering().backend
    set_default_lowering(LoweringConfig.from_registry(backend))
    return prior


def get_default_backend() -> str:
    """Backend name of the process-default LoweringConfig."""
    return default_lowering().backend
