"""Compile-cache keys and the op → target-ISAX view of the registry.

This is the front half of the dispatch pipeline (trace → saturate → match →
schedule → kernel).  The trace programs themselves — the deliberately
divergent software-side loop nests for every hot op — live on the
``repro_torch.targets`` domain packages (``IsaxSpec.trace_program``); this
module keeps the cache key (:class:`OpKey`) and thin views of the
registry: ``TARGET_ISAX``, ``trace_kind`` and ``trace_term``.

``OpKey`` is the compile-cache key: one entry per (op, shape, dtype,
backend).  Shape tuples are per-op conventions (documented on ``OpKey``)
chosen so that every distinct kernel-schedule decision gets its own entry
while batch-irrelevant details are folded away.  Op names are validated
against the dispatcher's registry at lowering time (not here), so keys for
custom-registry domains construct cleanly.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

from repro_torch.core.expr import Term
from repro_torch.targets import default_registry


class _TargetIsaxView(Mapping):
    """Live ``op → target-ISAX-or-None`` mapping over the global registry:
    iteration order is registration order, membership tracks whatever
    domains are registered, and a ``None`` value marks a deliberate
    negative control."""

    def __getitem__(self, op: str):
        return default_registry().target_isax(op)

    def __iter__(self):
        return iter(default_registry().ops())

    def __len__(self):
        return len(default_registry().ops())

    def __repr__(self):
        return f"TARGET_ISAX({dict(self)!r})"


#: op name → the ISAX the compiler is expected to be able to target (None
#: means "no specialized datapath exists" — a deliberate negative control
#: whose keys must lower to the plain version).  Derived live from the
#: ``repro_torch.targets`` registry.
TARGET_ISAX: Mapping = _TargetIsaxView()


class _OpKeyFields(NamedTuple):
    op: str
    shape: tuple[int, ...]
    dtype: str
    backend: str


class OpKey(_OpKeyFields):
    """Compile-cache key: one persistent entry per (op, shape, dtype, backend).

    Shape conventions (built-in domains):
      attention / attention_decode / attention_paged: (B, S, H, K, T, hd)
      rmsnorm:     (rows, d)
      matmul:      (rows, d_in, d_out)
      int8_matmul: (rows, d_in, d_out)
      ssd_scan:    (b, s, H, P, N)
      fps:             (B, n_points, n_samples)
      ball_query:      (B, n_points, n_centers, k)
      group_aggregate: (B, n_points, n_centers, k, channels)

    New domains document their conventions on their ``IsaxSpec`` entries.

    A key is a plain tuple underneath: it hashes and compares equal to the
    raw ``(op, shape, dtype, backend)`` tuple, so a repeated lookup probes
    ``Dispatcher.records`` with that tuple and builds no key.
    """

    __slots__ = ()

    def __new__(cls, op: str, shape, dtype: str, backend: str):
        if not op or not isinstance(op, str):
            raise ValueError(f"OpKey.op must be a non-empty string, "
                             f"got {op!r}")
        return super().__new__(cls, op, tuple(int(s) for s in shape), dtype,
                               backend)


def trace_kind(op: str) -> str:
    """Trace kind an op's e-graph outcome is memoized under (attention
    prefill/decode/paged all share the ``attention`` saturation run).  The
    engine memoizes on the spec object itself; this reports its label."""
    return default_registry().op_spec(op).trace_kind


def trace_term(kind: str) -> Term:
    """The software-side program for one trace kind, resolved through the
    registry (terms are shape-independent)."""
    return default_registry().spec_for_kind(kind).trace_program()
