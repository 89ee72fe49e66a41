"""Generic compile-cache engine over the declarative ISAX/domain registry.

For each ``OpKey`` (op, shape, dtype, backend) the dispatcher runs the full
retargetable-compiler flow over the traced software program — equality
saturation (``core/rewrites``) interleaved with ISAX-guided external loop
transforms, then skeleton/component matching (``core/matching``) — and
decides whether to extract an ``isax:*`` kernel call (the spec's bound
kernel route, with a schedule from the spec's scheduler) or keep the plain
torch version.  Decisions live in a persistent in-process compile cache,
so the e-graph work is paid once per trace spec and the schedule decision
once per shape.

The engine is registry-generic: it imports no domain module, names no op,
and holds no scheduler/kernel tables.  Everything op-specific — trace
program, target ISAX, scheduler, kernel route, chunked policy — comes from
the ``repro_torch.targets`` registry (``IsaxSpec``).

Invariants (the reference's, ``repro/compile/dispatch.py``):

* **Cache key** — the cache is keyed on the full ``OpKey(op, shape, dtype,
  backend)``; equal keys return the same ``CompileRecord`` object.  An
  ``OpKey`` is a tuple, so a lookup may pass the raw tuple: a cached one
  is a single probe of ``records``.  Only a miss records a span
  (``lower.decide``, ``repro_torch.obs``, with the spec's e-graph run
  where its first key triggers it); a hit records none.
* **E-graph amortization** — saturation/matching outcomes are memoized per
  registry spec identity (attention prefill/decode/paged share one run);
  schedules and impl decisions are per key.
* **Recorded schedules are the executed schedules** — a record's schedule
  (kernel, plan, ring depth, baseline or pipelined) comes from the same
  ``kernels/schedule.py`` function the kernel routes call when no schedule
  is passed, and the model layers hand the record's schedule to the route.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch import obs
from repro_torch.compile.trace import OpKey
from repro_torch.core.offload import compile_program
from repro_torch.targets import default_registry
from repro_torch.targets.registry import IsaxSpec, TargetRegistry


@dataclasses.dataclass(frozen=True)
class MatchOutcome:
    """E-graph compilation result for one trace spec (shape-independent)."""

    matched: tuple[str, ...]
    internal_rewrites: int
    external_rewrites: int
    initial_enodes: int
    saturated_enodes: int


@dataclasses.dataclass
class CompileRecord:
    """One compile-cache entry: the match result and lowering decision for a
    single (op, shape, dtype, backend) tuple."""

    key: OpKey
    impl: str                      # 'isax' | 'chunked' | 'reference'
    matched: tuple[str, ...]       # every ISAX the e-graph pipeline matched
    target: Optional[str]          # the ISAX this op is expected to target
    kernel_fn: Optional[Callable]  # the bound kernel route when impl == 'isax'
    schedule: Optional[dict]       # the Hopper schedule when impl == 'isax'
    note: str                      # human-readable decision rationale
    outcome: MatchOutcome
    hits: int = 0

    @property
    def target_matched(self) -> bool:
        """True iff the e-graph pipeline matched this op's target ISAX."""
        return self.target is not None and self.target in self.matched

    def row(self) -> dict:
        """Flatten the record (for ``Dispatcher.stats``)."""
        return {
            "op": self.key.op, "shape": list(self.key.shape),
            "dtype": self.key.dtype, "backend": self.key.backend,
            "impl": self.impl, "matched": list(self.matched),
            "target": self.target, "schedule": self.schedule,
            "note": self.note, "hits": self.hits,
            "internal_rewrites": self.outcome.internal_rewrites,
            "external_rewrites": self.outcome.external_rewrites,
            "saturated_enodes": self.outcome.saturated_enodes,
        }


class Dispatcher:
    """Persistent in-process compile cache over the e-graph ISAX pipeline.

    ``lower`` is the entry point the models call.  E-graph outcomes are
    memoized per registry spec, schedules and impl decisions per key.
    Pass ``registry=`` to bind a custom :class:`TargetRegistry`; the
    default is the global ``repro_torch.targets`` registry.
    """

    def __init__(self, registry: Optional[TargetRegistry] = None):
        self.registry = registry if registry is not None else default_registry()
        self.records: dict[OpKey, CompileRecord] = {}
        #: spec identity → MatchOutcome (keyed on the IsaxSpec object)
        self._outcomes: dict[IsaxSpec, MatchOutcome] = {}
        self.hits = 0
        self.misses = 0

    def match_outcome(self, spec: IsaxSpec) -> MatchOutcome:
        """E-graph saturation + matching for one trace spec (memoized on
        the spec's identity)."""
        out = self._outcomes.get(spec)
        if out is None:
            res = compile_program(
                spec.trace_program(), self.registry.isaxes(),
                case=f"dispatch/{spec.domain}/{spec.trace_kind}")
            s = res.stats
            out = MatchOutcome(tuple(dict.fromkeys(s.matched_isaxes)),
                               s.internal_rewrites, s.external_rewrites,
                               s.initial_enodes, s.saturated_enodes)
            self._outcomes[spec] = out
        return out

    def lower(self, key) -> CompileRecord:
        """The compile-cache lookup: the (memoized) lowering decision for
        one (op, shape, dtype, backend) key, an ``OpKey`` or the raw tuple
        (shape a tuple of ints, dtype its name)."""
        rec = self.records.get(key)
        if rec is not None:
            self.hits += 1
            rec.hits += 1
            return rec
        key = OpKey(*key)
        self.misses += 1
        with obs.span("lower.decide"):
            rec = self._decide(key)
        self.records[key] = rec
        return rec

    def _decide(self, key: OpKey) -> CompileRecord:
        spec = self.registry.op_spec(key.op)  # ValueError on unknown op
        outcome = self.match_outcome(spec)
        target = spec.target
        matched = target is not None and target in outcome.matched

        def _rec(impl, kernel_fn=None, schedule=None, note=""):
            return CompileRecord(key=key, impl=impl, matched=outcome.matched,
                                 target=target, kernel_fn=kernel_fn,
                                 schedule=schedule, note=note,
                                 outcome=outcome)

        if key.backend == "cuda":
            if not matched:
                return _rec("reference",
                            note="no ISAX matched; plain version")
            schedule, why = spec.scheduler(key)
            if schedule is None:
                return _rec("reference",
                            note=f"{target} matched but {why}; plain version")
            return _rec("isax", kernel_fn=spec.kernel,
                        schedule=schedule, note=f"extracted isax:{target}")
        if key.backend == "torch_chunked" and spec.chunked is not None:
            if key.shape[spec.chunked.axis] > 1:
                return _rec("chunked", note=spec.chunked.note)
            return _rec("reference", note=spec.chunked.fallback_note)
        return _rec("reference", note=f"backend {key.backend}: plain version"
                    + ("" if not matched else f" ({target} matched)"))

    def stats(self) -> dict:
        """Aggregate match-rate / cache-hit-rate plus per-key rows."""
        recs = list(self.records.values())
        n = len(recs)
        matched = sum(1 for r in recs if r.target_matched)
        isax = sum(1 for r in recs if r.impl == "isax")
        pipelined = sum(1 for r in recs
                        if r.schedule and r.schedule.get("pipelined"))
        lookups = self.hits + self.misses
        return {
            "n_keys": n,
            "matched_keys": matched,
            "isax_keys": isax,
            "pipelined_keys": pipelined,
            "match_rate": matched / n if n else 0.0,
            "isax_rate": isax / n if n else 0.0,
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "ops": [r.row() for r in recs],
        }


_DISPATCHER: Optional[Dispatcher] = None


def get_dispatcher() -> Dispatcher:
    """The process-wide compile cache, bound to the global registry."""
    global _DISPATCHER
    if _DISPATCHER is None:
        _DISPATCHER = Dispatcher()
    return _DISPATCHER
