"""Interface-aware synthesis-time optimization (Aquas paper §4.3).

Three progressive passes over Aquas-IR:

  1. **Scratchpad buffer elision** (functional level) — decide whether explicit
     staging buffers can be elided in favour of direct main-memory access.
  2. **Interface selection & canonicalization** (functional → architectural) —
     assign every memory op to exactly one interface by minimizing

         Σ_k T_k  +  Σ_{q,k} X(q,k) · ⌈m_q / C_k⌉ · C_k / W_k

     and greedily split each op into legal transfer sizes (decreasing).
  3. **Transaction scheduling & ordering** (architectural → temporal) — find
     the minimal-latency issue order under the in-flight limit I_k via a
     memoized search whose state is compressed into a relative timing window
     (latency recurrences are insensitive to global time translation), then
     lower to asynchronous issue/wait pairs chained by ``after``.

On fixed silicon the resulting TemporalProgram is the hardware description
that can still be generated: a copy schedule, whose cycle count
``kernel_synth.py`` weighs against each kernel's compute (on the H100: a
block's ``cp.async``/TMA copies into shared memory).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

from repro_torch.core import aquas_ir as ir
from repro_torch.core.interface_model import (
    MemInterface,
    approx_latency,
    cache_sync_penalty,
    sequence_latency,
)

# Exhaustive assignment search is exact up to this many ops per direction;
# beyond it we fall back to greedy + pairwise local search.
_EXACT_ASSIGN_LIMIT = 8
_EXACT_ORDER_LIMIT = 9


# ---------------------------------------------------------------------------
# Pass 1: scratchpad buffer elision (§4.3)
# ---------------------------------------------------------------------------

def _elision_legal(sp: ir.ScratchpadDecl) -> bool:
    """Paper: elision is disabled for scratchpads accessed within unrolled
    regions, outside pipelined loops, or used purely as local temporaries."""
    if sp.accessed_in_unrolled_region:
        return False
    if not sp.inside_pipelined_loop:
        return False
    if sp.purely_local_temp:
        return False
    return True


def _elision_profitable(
    sp: ir.ScratchpadDecl,
    fill_op: ir.FuncOp | None,
    interfaces: dict[str, MemInterface],
) -> bool:
    """Affine analysis + tentative rescheduling check.

    Staged cost   = bulk-transfer latency (fill) + per-element reads are free
                    (on-chip).
    Elided cost   = per-element global accesses; each element's lead-off can
                    hide behind ``compute_cycles_per_elem`` of datapath work,
                    and reuse multiplies traffic.
    Elision also rejected when the reuse factor would thrash the cache
    (reuse > 1 means each global re-read may miss).
    """
    if fill_op is None:
        return False
    if sp.reuse_factor > 1:
        return False  # affine analysis: elision would trigger cache thrashing

    best = min(interfaces.values(), key=lambda k: k.L)
    n_elems = max(1, sp.size_bytes // max(1, sp.elem_bytes))

    # staged: one bulk transfer of the whole buffer on the widest-suitable path
    bulk_itfc = max(interfaces.values(), key=lambda k: k.W * min(k.M, 64))
    bulk_cycles = sequence_latency(
        bulk_itfc, bulk_itfc.decompose(sp.size_bytes), "load")

    # elided: n per-element loads; each hides up to compute_cycles_per_elem
    per_elem = sequence_latency(best, [best.W], "load")
    exposed = max(0.0, per_elem - sp.compute_cycles_per_elem)
    elided_cycles = exposed * n_elems

    return elided_cycles <= bulk_cycles


def elide_scratchpads(
    prog: ir.FunctionalProgram,
    interfaces: dict[str, MemInterface],
) -> tuple[ir.FunctionalProgram, dict[str, str]]:
    """Rewrite read_smem → global fetch for every elidable scratchpad and drop
    the corresponding staging transfer (paper Figure 4(a))."""
    decisions: dict[str, str] = {}
    elided: set[str] = set()
    for name, sp in prog.scratchpads.items():
        fill = next(
            (op for op in prog.ops
             if op.kind == "transfer" and op.dst_space == ir.Space.SCRATCHPAD
             and op.scratchpad == name),
            None,
        )
        if _elision_legal(sp) and _elision_profitable(sp, fill, interfaces):
            elided.add(name)
            decisions[f"scratchpad:{name}"] = "elided"
        else:
            decisions[f"scratchpad:{name}"] = "kept"

    new_ops: list[ir.FuncOp] = []
    for op in prog.ops:
        if op.scratchpad in elided:
            if op.kind == "transfer":
                continue  # staging transfer removed
            if op.kind == "read_smem":
                new_ops.append(ir.FuncOp(
                    kind="fetch", name=op.name, size_bytes=op.size_bytes,
                    src_space=ir.Space.GLOBAL, dst_space=ir.Space.REG,
                    direction="load", cache_hint=op.cache_hint,
                    base_align=op.base_align))
                continue
            if op.kind == "write_smem":
                new_ops.append(ir.FuncOp(
                    kind="transfer", name=op.name, size_bytes=op.size_bytes,
                    src_space=ir.Space.REG, dst_space=ir.Space.GLOBAL,
                    direction="store", cache_hint=op.cache_hint,
                    base_align=op.base_align))
                continue
        new_ops.append(op)

    kept = {n: sp for n, sp in prog.scratchpads.items() if n not in elided}
    return ir.FunctionalProgram(prog.name, new_ops, kept), decisions


# ---------------------------------------------------------------------------
# Pass 2: interface selection & canonicalization (§4.3)
# ---------------------------------------------------------------------------

def _hierarchy_mismatch(op: ir.FuncOp, itfc: MemInterface) -> bool:
    """cache_hint machinery (§4.1): warm data on a DRAM-level interface (or
    cold data on a cache-level interface) incurs synchronization cycles."""
    if op.cache_hint == ir.CacheHint.WARM:
        return itfc.hierarchy_level >= 1
    if op.cache_hint == ir.CacheHint.COLD:
        return itfc.hierarchy_level == 0
    return False


def _objective(
    assign: Sequence[int],
    ops: Sequence[ir.FuncOp],
    itfcs: Sequence[MemInterface],
    direction: str,
) -> float:
    """min Σ_k T_k + Σ_{q,k} X(q,k)·⌈m_q/C_k⌉·C_k/W_k  (cache term applied on
    hierarchy mismatch, per §4.1/§4.3)."""
    total = 0.0
    for ki, itfc in enumerate(itfcs):
        chunks = [itfc.decompose(op.size_bytes)
                  for op, a in zip(ops, assign) if a == ki]
        if chunks:
            total += approx_latency(itfc, chunks, direction)  # T_k
    for op, a in zip(ops, assign):
        itfc = itfcs[a]
        if _hierarchy_mismatch(op, itfc):
            total += cache_sync_penalty(itfc, op.size_bytes)
    return total


def _assign_exact(ops, itfcs, direction):
    best, best_cost = None, math.inf
    for assign in itertools.product(range(len(itfcs)), repeat=len(ops)):
        c = _objective(assign, ops, itfcs, direction)
        if c < best_cost:
            best, best_cost = assign, c
    return list(best), best_cost


def _assign_greedy(ops, itfcs, direction):
    """Greedy seed + pairwise local search for large op counts."""
    assign = []
    for q in range(len(ops)):
        costs = []
        for k in range(len(itfcs)):
            trial = assign + [k] + [0] * (len(ops) - q - 1)
            costs.append(_objective(trial[: q + 1], ops[: q + 1], itfcs, direction))
        assign.append(min(range(len(itfcs)), key=lambda k: costs[k]))
    improved = True
    while improved:
        improved = False
        cur = _objective(assign, ops, itfcs, direction)
        for q in range(len(ops)):
            for k in range(len(itfcs)):
                if k == assign[q]:
                    continue
                trial = list(assign)
                trial[q] = k
                c = _objective(trial, ops, itfcs, direction)
                if c < cur - 1e-9:
                    assign, cur, improved = trial, c, True
    return assign, _objective(assign, ops, itfcs, direction)


def select_interfaces(
    prog: ir.FunctionalProgram,
    interfaces: dict[str, MemInterface],
) -> ir.ArchitecturalProgram:
    """Lower functional memory ops to architectural copy/load ops bound to one
    interface each, canonicalized into legal transfer sequences."""
    itfcs = list(interfaces.values())
    arch_ops: list[ir.ArchOp] = []
    decisions: dict[str, str] = {}

    mem_ops = [op for op in prog.ops
               if op.src_space == ir.Space.GLOBAL or op.dst_space == ir.Space.GLOBAL]
    for direction in ("load", "store"):
        dir_ops = [op for op in mem_ops if op.direction == direction]
        if not dir_ops:
            continue
        if len(dir_ops) <= _EXACT_ASSIGN_LIMIT and len(itfcs) ** len(dir_ops) <= 65536:
            assign, cost = _assign_exact(dir_ops, itfcs, direction)
        else:
            assign, cost = _assign_greedy(dir_ops, itfcs, direction)
        decisions[f"objective:{direction}"] = f"{cost:.1f}"
        for op, ki in zip(dir_ops, assign):
            itfc = itfcs[ki]
            decisions[f"itfc:{op.name}"] = itfc.name
            chunks = itfc.decompose(op.size_bytes, addr=0)
            kind = "copy" if len(chunks) > 1 or chunks[0] > itfc.W else "load"
            for p, m in enumerate(chunks):
                arch_ops.append(ir.ArchOp(
                    kind=kind, name=op.name, size_bytes=m, itfc=itfc,
                    direction=direction, seq_index=p, cache_hint=op.cache_hint))

    return ir.ArchitecturalProgram(prog.name, arch_ops, dict(prog.scratchpads),
                                   decisions)


# ---------------------------------------------------------------------------
# Pass 3: transaction scheduling & ordering (§4.3)
# ---------------------------------------------------------------------------

def _group_key(ops: list[ir.ArchOp], direction: str) -> float:
    """Hierarchy grouping rule: reads — top of hierarchy (level 0) first so
    cold data doesn't evict hot; writes — bottom first so hot data stays."""
    lvl = ops[0].itfc.hierarchy_level
    return lvl if direction == "load" else -lvl


def _order_groups_for_interface(
    itfc: MemInterface,
    groups: list[list[int]],      # groups of sizes; each group stays contiguous
    direction: str,
) -> tuple[list[int], float]:
    """Minimal-latency contiguous-group order on one interface via memoized
    search.  State is compressed to a relative timing window: the recurrences
    only ever look back I transactions, and are translation-invariant, so the
    search key is (frozenset of remaining groups, last-I completion deltas)."""
    n = len(groups)
    if n == 0:
        return [], 0.0

    def run(seq_sizes: list[int]) -> float:
        return float(sequence_latency(itfc, seq_sizes, direction))

    if n <= _EXACT_ORDER_LIMIT:
        best_perm, best_cost = None, math.inf
        # memoized branch & bound over group permutations
        @functools.lru_cache(maxsize=None)
        def dp(remaining: frozenset, window: tuple) -> tuple[float, tuple]:
            if not remaining:
                return (max(window) if window else 0.0, ())
            best = (math.inf, ())
            base = min(window) if window else 0.0
            for gi in remaining:
                sizes = groups[gi]
                # simulate appending this group onto the window
                a_prev = base  # translation-compressed issue reference
                b = list(window)
                a_hist = [a_prev]
                for m in sizes:
                    beats = m / itfc.W
                    b_wait = b[-itfc.I] if len(b) >= itfc.I else -1.0
                    a_j = 1 + max(a_hist[-1], b_wait)
                    if direction == "load":
                        b_j = beats + max(b[-1] if b else -1.0, a_j + itfc.L - 1)
                    else:
                        b_j = beats + itfc.E + max(b[-1] if b else -1.0, a_j - 1)
                    a_hist.append(a_j)
                    b.append(b_j)
                new_window = tuple(b[-itfc.I:])
                # translate so the memo key is relative
                shift = min(new_window)
                key_window = tuple(round(x - shift, 3) for x in new_window)
                sub_cost, sub_order = dp(remaining - {gi}, key_window)
                total = shift + sub_cost
                # note: a_hist translation folded into shift
                if total < best[0]:
                    best = (total, (gi,) + sub_order)
            return best

        # seed window: empty history
        cost, order = dp(frozenset(range(n)), ())
        dp.cache_clear()
        return list(order), cost

    # large: hierarchy-sorted + largest-first heuristic
    order = sorted(range(n), key=lambda gi: (-sum(groups[gi]),))
    flat = [m for gi in order for m in groups[gi]]
    return order, run(flat)


def schedule_transactions(
    arch: ir.ArchitecturalProgram,
) -> ir.TemporalProgram:
    """Lower architectural transfers to ordered asynchronous issue/wait pairs."""
    temporal_ops: list[ir.TemporalOp] = []
    decisions = dict(arch.decisions)
    op_id = 0
    total_cycles = 0.0

    for direction in ("load", "store"):
        # bucket by interface; within an interface, group by originating op
        by_itfc: dict[str, list[ir.ArchOp]] = {}
        for a in arch.ops:
            if a.direction == direction:
                by_itfc.setdefault(a.itfc.name, []).append(a)

        for itfc_name, ops in by_itfc.items():
            itfc = ops[0].itfc
            # contiguity: decomposed segments of one memory op stay together
            by_src: dict[str, list[ir.ArchOp]] = {}
            for a in ops:
                by_src.setdefault(a.name, []).append(a)
            # hierarchy grouping first (stable), then memoized order search
            group_names = sorted(
                by_src.keys(),
                key=lambda nm: _group_key(by_src[nm], direction))
            groups = [[a.size_bytes for a in
                       sorted(by_src[nm], key=lambda a: a.seq_index)]
                      for nm in group_names]
            order, cost = _order_groups_for_interface(itfc, groups, direction)
            decisions[f"order:{itfc_name}:{direction}"] = ",".join(
                group_names[i] for i in order)
            total_cycles = max(total_cycles, cost)

            # emit issue ops chained with `after`, then one wait
            flat: list[tuple[str, int]] = []
            for gi in order:
                for m in groups[gi]:
                    flat.append((group_names[gi], m))
            sizes = [m for _, m in flat]
            # exact per-op timing from the §4.1 recurrences
            a_t = [-1.0]
            b_t = [-1.0]
            prev_id = None
            for j, (nm, m) in enumerate(flat, start=1):
                beats = m / itfc.W
                b_wait = b_t[j - itfc.I] if j - itfc.I >= 1 else -1.0
                a_j = 1 + max(a_t[j - 1], b_wait)
                if direction == "load":
                    b_j = beats + max(b_t[j - 1], a_j + itfc.L - 1)
                else:
                    b_j = beats + itfc.E + max(b_t[j - 1], a_j - 1)
                a_t.append(a_j)
                b_t.append(b_j)
                top = ir.TemporalOp(
                    kind="copy_issue", op_id=op_id, name=nm, size_bytes=m,
                    itfc=itfc, direction=direction, after=prev_id,
                    issue_cycle=a_j, complete_cycle=b_j)
                temporal_ops.append(top)
                prev_id = op_id
                op_id += 1
            if flat:
                temporal_ops.append(ir.TemporalOp(
                    kind="copy_wait", op_id=op_id, name=f"{itfc_name}:{direction}",
                    size_bytes=0, itfc=itfc, direction=direction, after=prev_id,
                    issue_cycle=b_t[-1], complete_cycle=b_t[-1]))
                op_id += 1
                total_cycles = max(total_cycles, b_t[-1])

    return ir.TemporalProgram(arch.name, temporal_ops, total_cycles,
                              dict(arch.scratchpads), decisions)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def synthesize(
    prog: ir.FunctionalProgram,
    interfaces: dict[str, MemInterface],
) -> ir.TemporalProgram:
    """Functional → Temporal: elision, selection/canonicalization, scheduling."""
    elided, d1 = elide_scratchpads(prog, interfaces)
    arch = select_interfaces(elided, interfaces)
    arch.decisions.update(d1)
    return schedule_transactions(arch)
