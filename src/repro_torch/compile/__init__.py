"""Compiler-driven kernel dispatch of the port (trace → saturate → match →
schedule → kernel) over the declarative ``repro_torch.targets`` registry.

Public entry points of the retargetable lowering API:

* ``lower(op, *, shape, dtype, backend=None)`` — one-shot compile-cache
  lookup through the global registry.
* ``LoweringConfig.from_registry(backend, registry=...)`` — a threadable
  policy, optionally bound to an isolated :class:`TargetRegistry`.
"""

from repro_torch.compile.config import (
    VALID_BACKENDS,
    LoweringConfig,
    default_lowering,
    get_default_backend,
    lower,
    set_default_backend,
    set_default_lowering,
)
from repro_torch.compile.dispatch import (
    CompileRecord,
    Dispatcher,
    MatchOutcome,
    get_dispatcher,
)
from repro_torch.compile.trace import TARGET_ISAX, OpKey

__all__ = [
    "VALID_BACKENDS",
    "LoweringConfig",
    "default_lowering",
    "get_default_backend",
    "lower",
    "set_default_backend",
    "set_default_lowering",
    "CompileRecord",
    "Dispatcher",
    "MatchOutcome",
    "get_dispatcher",
    "TARGET_ISAX",
    "OpKey",
]
