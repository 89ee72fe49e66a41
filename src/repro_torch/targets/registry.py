"""Declarative ISAX/domain registry — the retargetable-lowering backbone.

The paper's headline compiler claim is *retargetability*: a new ISAX or a
new application domain should plug into the e-graph matching engine, not be
hand-wired through it.  This module is the plug: everything one ISAX needs
is bundled in a frozen :class:`IsaxSpec` —

* the skeleton/component definition (``core/matching.ISAX`` factory),
* evaluator semantics (the numpy oracle ``core/offload.evaluate`` binds),
* the bridging internal rewrites its software spellings rely on,
* the divergent trace-program builder and its saturation memo kind,
* the scheduler (the H100 schedule of ``kernels/schedule.py``), and
* the baseline and pipelined kernel routes (CUDA on the card)

— and a :class:`DomainPackage` registers a set of specs into the global
registry at import time (``repro_torch.targets`` imports the built-in ``llm`` and
``pointcloud`` domains).  ``compile/dispatch.py`` is a generic engine over
registered specs: it holds no per-domain imports, no per-op ``if`` ladders,
and no hand-maintained scheduler/kernel dicts.  Adding a domain means
writing one module with a ``DomainPackage`` and registering it — the
acceptance test for this design registers a toy third domain in a single
file and is matched, scheduled, cached, and dispatched by the unchanged
engine.

Spec objects use *identity* semantics (``eq=False``): the dispatcher's
saturation memo is keyed on the spec object itself, so two domains can
never alias a trace kind by picking the same kind string.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:  # OpKey/ISAX are type-only: targets never imports compile
    from repro_torch.compile.trace import OpKey
    from repro_torch.core.matching import ISAX

#: scheduler contract: OpKey -> (schedule dict, "ok") or (None, why-not).
SchedulerFn = Callable[["OpKey"], "tuple[Optional[dict], str]"]


@dataclasses.dataclass(frozen=True)
class ChunkedLowering:
    """Declarative ``torch_chunked`` policy for ops that have a chunked
    plain-torch lowering (today: the attention family's online-softmax
    loop over key chunks).

    ``axis`` is the OpKey.shape axis that must exceed 1 for chunking to be
    worthwhile; below that the engine records ``fallback_note`` and keeps
    the reference.
    """

    axis: int
    note: str
    fallback_note: str


@dataclasses.dataclass(frozen=True, eq=False)
class IsaxSpec:
    """One ISAX (or reference-only op family), fully self-contained.

    ``isax=None`` declares a *negative control*: ops that trace and
    saturate like everything else but deliberately have no specialized
    datapath (their target is ``None`` and they must lower to the plain
    version).  ``ops=()`` declares a library-only ISAX that participates
    in matching/evaluation but has no dispatch key yet (e.g. ``swiglu``).

    Identity semantics (``eq=False``): the spec object *is* the saturation
    memo key, so equal-looking specs from different domains never share an
    e-graph outcome.
    """

    name: str
    isax: Optional[Callable[[], "ISAX"]] = None
    evaluator: Optional[Callable] = None
    trace_kind: Optional[str] = None
    trace_program: Optional[Callable[[], tuple]] = None
    ops: tuple[str, ...] = ()
    rewrites: tuple[str, ...] = ()
    scheduler: Optional[SchedulerFn] = None
    kernel: Optional[Callable] = None
    kernel_pipelined: Optional[Callable] = None
    chunked: Optional[ChunkedLowering] = None
    op_notes: tuple[tuple[str, str], ...] = ()
    description: str = ""
    domain: Optional[str] = None  # stamped by the registry at registration

    @property
    def target(self) -> Optional[str]:
        """ISAX name the ops are expected to extract, or None (negative
        control / reference-only op)."""
        return self.name if self.isax is not None else None

    def validate(self) -> None:
        """Raise ValueError unless the spec is complete enough to dispatch.

        Every spec that owns dispatch ops needs a trace program (the engine
        must be able to saturate it); every *matchable* spec (``isax`` set)
        additionally needs evaluator semantics, and — when it owns ops — a
        scheduler and a resolvable kernel entry point.
        """
        if not self.name:
            raise ValueError("IsaxSpec needs a non-empty name")
        if self.ops:
            if self.trace_program is None or not self.trace_kind:
                raise ValueError(
                    f"spec {self.name!r} owns ops {self.ops} but has no "
                    "trace_program/trace_kind")
        if self.isax is not None:
            built = self.isax()
            if built.name != self.name:
                raise ValueError(
                    f"spec {self.name!r} builds an ISAX named "
                    f"{built.name!r}; names must agree")
            if self.evaluator is None:
                raise ValueError(
                    f"spec {self.name!r} has no evaluator semantics")
            if self.ops and (self.scheduler is None or self.kernel is None):
                raise ValueError(
                    f"spec {self.name!r} owns ops {self.ops} but is missing "
                    f"{'a scheduler' if self.scheduler is None else ''}"
                    f"{' and ' if self.scheduler is None and self.kernel is None else ''}"
                    f"{'a kernel entry point' if self.kernel is None else ''}")


@dataclasses.dataclass(frozen=True)
class DomainPackage:
    """A named application domain: an ordered set of IsaxSpecs registered
    together (``llm``, ``pointcloud``, your domain here)."""

    name: str
    specs: tuple[IsaxSpec, ...]
    description: str = ""


class TargetRegistry:
    """Ordered ISAX/domain registry the generic dispatch engine iterates.

    Invariants (enforced at ``register`` time, atomically — a rejected
    package leaves the registry untouched):

    * domain names are unique,
    * spec names are unique across all domains,
    * dispatch op names are unique across all domains,
    * every spec passes :meth:`IsaxSpec.validate`.

    ``isaxes()`` preserves registration order — saturation outcomes depend
    on library order, so the built-in domains register in the historical
    ``isax_library()`` order and new domains append after them.
    """

    def __init__(self):
        self._domains: dict[str, DomainPackage] = {}
        self._specs: dict[str, IsaxSpec] = {}
        self._ops: dict[str, IsaxSpec] = {}
        self._isax_cache: Optional[list] = None

    # -- registration -------------------------------------------------------

    def register(self, package: DomainPackage) -> DomainPackage:
        """Register a domain package; returns the bound (domain-stamped)
        package.  Raises ValueError on any name/op collision."""
        if package.name in self._domains:
            raise ValueError(f"domain {package.name!r} is already registered")
        bound_specs = []
        seen_names, seen_ops = set(), set()
        for spec in package.specs:
            spec = dataclasses.replace(spec, domain=package.name)
            spec.validate()
            if spec.name in self._specs or spec.name in seen_names:
                raise ValueError(
                    f"duplicate ISAX spec name {spec.name!r} "
                    f"(domain {package.name!r})")
            seen_names.add(spec.name)
            for op in spec.ops:
                if op in self._ops or op in seen_ops:
                    raise ValueError(
                        f"duplicate dispatch op {op!r} (domain "
                        f"{package.name!r}, spec {spec.name!r})")
                seen_ops.add(op)
            bound_specs.append(spec)
        bound = DomainPackage(package.name, tuple(bound_specs),
                              package.description)
        self._domains[bound.name] = bound
        for spec in bound.specs:
            self._specs[spec.name] = spec
            for op in spec.ops:
                self._ops[op] = spec
        self._isax_cache = None
        return bound

    # -- lookup -------------------------------------------------------------

    def domains(self) -> dict[str, DomainPackage]:
        """Registered domain packages by name (registration order)."""
        return dict(self._domains)

    def specs(self) -> list[IsaxSpec]:
        """All registered specs in registration order."""
        return list(self._specs.values())

    def spec(self, name: str) -> IsaxSpec:
        """Spec by ISAX name; KeyError with the known names otherwise."""
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(f"unknown ISAX spec {name!r}; "
                           f"known: {sorted(self._specs)}") from None

    def ops(self) -> list[str]:
        """All dispatch op names in registration order."""
        return list(self._ops)

    def has_op(self, op: str) -> bool:
        """True when some registered spec owns dispatch op ``op``."""
        return op in self._ops

    def op_spec(self, op: str) -> IsaxSpec:
        """Spec owning dispatch op ``op``; ValueError listing the valid ops
        otherwise (the dispatcher's unknown-op error)."""
        try:
            return self._ops[op]
        except KeyError:
            raise ValueError(f"unknown dispatch op {op!r}; "
                             f"known: {sorted(self._ops)}") from None

    def target_isax(self, op: str) -> Optional[str]:
        """ISAX name op is expected to extract, or None (negative control).
        Raises KeyError for unregistered ops (mapping semantics)."""
        if op not in self._ops:
            raise KeyError(op)
        return self._ops[op].target

    def spec_for_kind(self, kind: str) -> IsaxSpec:
        """First spec whose trace kind is ``kind``."""
        for spec in self._specs.values():
            if spec.trace_kind == kind:
                return spec
        raise KeyError(f"no registered spec traces kind {kind!r}")

    # -- derived views ------------------------------------------------------

    def isaxes(self) -> list:
        """The ISAX library: every matchable spec's definition, built once,
        in registration order (the order saturation sees)."""
        if self._isax_cache is None:
            self._isax_cache = [s.isax() for s in self._specs.values()
                                if s.isax is not None]
        return list(self._isax_cache)

    def evaluators(self) -> dict[str, Callable]:
        """ISAX name → numpy evaluator semantics (the table
        ``core/offload.evaluate`` derives its intrinsics from)."""
        return {s.name: s.evaluator for s in self._specs.values()
                if s.evaluator is not None}


# ---------------------------------------------------------------------------
# The global registry (the "aquas.targets" registry of the redesign)
# ---------------------------------------------------------------------------

_REGISTRY = TargetRegistry()
_BUILTINS_LOADED = False


def _load_builtin_domains() -> None:
    """Import-and-register the built-in domains exactly once, in the
    historical library order (llm first, then pointcloud)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from repro_torch.targets import llm, pointcloud
    _REGISTRY.register(llm.DOMAIN)
    _REGISTRY.register(pointcloud.DOMAIN)


def default_registry() -> TargetRegistry:
    """The process-wide registry (built-in domains loaded on first use)."""
    _load_builtin_domains()
    return _REGISTRY


def register_domain(package: DomainPackage) -> DomainPackage:
    """Register a new domain package into the global registry (built-ins
    are loaded first, so user domains always append after them)."""
    return default_registry().register(package)
