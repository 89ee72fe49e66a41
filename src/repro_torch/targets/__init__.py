"""``repro_torch.targets`` — the global declarative ISAX/domain registry.

Importing this package loads the built-in ``llm`` and ``pointcloud``
domain packages into the global :class:`TargetRegistry`; the generic
dispatch engine (``compile/dispatch.py``) and the e-graph evaluator
(``core/offload.py``) derive everything — trace programs, the ISAX
library, evaluator intrinsics, schedulers, kernel entry points — from it.

To add a domain, write one module that builds a :class:`DomainPackage`
from :class:`IsaxSpec` entries and call :func:`register_domain` (or
register into your own :class:`TargetRegistry` and thread it through
``LoweringConfig.from_registry`` for isolation).
"""

from repro_torch.targets.registry import (
    ChunkedLowering,
    DomainPackage,
    IsaxSpec,
    TargetRegistry,
    default_registry,
    register_domain,
)

__all__ = [
    "ChunkedLowering",
    "DomainPackage",
    "IsaxSpec",
    "TargetRegistry",
    "default_registry",
    "register_domain",
    "isax_library",
    "evaluators",
]


def isax_library() -> list:
    """The registered ISAX library (registration order) — the canonical
    replacement for the deprecated ``core.offload.isax_library()``."""
    return default_registry().isaxes()


def evaluators() -> dict:
    """ISAX name → numpy evaluator semantics from the global registry."""
    return default_registry().evaluators()


# Load the built-in domains at import time (the declarative-registration
# contract: ``import repro_torch.targets`` is enough to populate the registry).
default_registry()
