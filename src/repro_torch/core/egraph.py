"""E-graph with anchor-aware program encoding (paper §2.3 and §5.2).

Standard equality-saturation machinery (union-find over e-classes, hashcons,
congruence-closure rebuild, e-matching, cost-based extraction — the egg [23]
recipe) plus the Aquas-specific program encoding:

  * each MLIR-block analogue becomes a ``tuple(...)`` e-node whose children
    are the block's *anchors* (terminators, side-effecting ops, structured
    control flow) in exact program order;
  * pure dataflow forms subtrees beneath the anchors that consume them.

Anchors are never rewritten by internal rules (rewrites.py guards on this),
which preserves ordering, dominance, and memory effects — the "critical
semantic relations" the paper calls out as overlooked by generic e-graph
pipelines.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Iterator, Optional

from repro_torch.core import expr
from repro_torch.core.expr import Term

ENode = tuple  # (op: str, *child_eclass_ids: int)


class EGraph:
    def __init__(self, node_limit: int = 50_000):
        self._parent: list[int] = []
        self.hashcons: dict[ENode, int] = {}
        self.classes: dict[int, set[ENode]] = {}
        self.uses: dict[int, set[ENode]] = {}  # child class -> user enodes
        self.node_limit = node_limit
        self._dirty: list[int] = []

    # ---- union-find ---------------------------------------------------------

    def find(self, x: int) -> int:
        while self._parent[x] != x:
            self._parent[x] = self._parent[self._parent[x]]
            x = self._parent[x]
        return x

    def _new_class(self) -> int:
        cid = len(self._parent)
        self._parent.append(cid)
        self.classes[cid] = set()
        self.uses[cid] = set()
        return cid

    # ---- add / union / rebuild ---------------------------------------------

    def canonicalize(self, node: ENode) -> ENode:
        return (node[0],) + tuple(self.find(c) for c in node[1:])

    def add_node(self, op: str, child_ids: Iterable[int]) -> int:
        node = (op,) + tuple(self.find(c) for c in child_ids)
        if node in self.hashcons:
            return self.find(self.hashcons[node])
        cid = self._new_class()
        self.hashcons[node] = cid
        self.classes[cid].add(node)
        for c in node[1:]:
            self.uses[c].add(node)
        return cid

    def add_term(self, t: Term) -> int:
        child_ids = [self.add_term(c) for c in expr.children(t)]
        return self.add_node(expr.op(t), child_ids)

    def union(self, a: int, b: int) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        # keep the smaller id as representative (stable for tests)
        if a > b:
            a, b = b, a
        self._parent[b] = a
        self.classes.setdefault(a, set()).update(self.classes.pop(b, set()))
        self.uses.setdefault(a, set()).update(self.uses.pop(b, set()))
        self._dirty.append(a)
        return a

    def rebuild(self) -> None:
        """Congruence closure via full re-canonicalization to fixpoint.

        Graphs in this domain are small (the paper's Table 3 tops out at
        ~2.8k e-nodes), so the O(n)-per-pass full rebuild is simpler and
        safer than incremental worklists.
        """
        while True:
            self._dirty.clear()
            new_hashcons: dict[ENode, int] = {}
            merged = False
            for node, cid in self.hashcons.items():
                canon = self.canonicalize(node)
                owner = self.find(cid)
                if canon in new_hashcons:
                    other = self.find(new_hashcons[canon])
                    if other != owner:
                        self.union(owner, other)
                        merged = True
                    new_hashcons[canon] = self.find(owner)
                else:
                    new_hashcons[canon] = owner
            self.hashcons = new_hashcons
            # rebuild classes/uses tables from the canonical hashcons
            classes: dict[int, set[ENode]] = {}
            uses: dict[int, set[ENode]] = {}
            for node, cid in self.hashcons.items():
                cid = self.find(cid)
                classes.setdefault(cid, set()).add(node)
                uses.setdefault(cid, set())
                for ch in node[1:]:
                    uses.setdefault(self.find(ch), set()).add(node)
            self.classes = classes
            self.uses = uses
            if not merged:
                break

    # ---- introspection -------------------------------------------------------

    def n_nodes(self) -> int:
        return len(self.hashcons)

    def n_classes(self) -> int:
        return len({self.find(i) for i in range(len(self._parent))})

    def nodes_of(self, cid: int) -> set[ENode]:
        return self.classes.get(self.find(cid), set())

    def class_has_op(self, cid: int, op: str) -> bool:
        return any(n[0] == op for n in self.nodes_of(cid))

    def iter_classes(self) -> Iterator[tuple[int, set[ENode]]]:
        for cid in list(self.classes.keys()):
            if self.find(cid) == cid:
                yield cid, self.classes[cid]

    # ---- e-matching ----------------------------------------------------------
    #
    # Patterns are Terms whose leaves may be pattern variables ('?x',).
    # A match yields a substitution {?x: eclass_id} plus the matched root id.

    def ematch(self, pattern: Term) -> list[tuple[dict[str, int], int]]:
        out = []
        for cid, _ in self.iter_classes():
            for sub in self._match_class(pattern, cid, {}):
                out.append((sub, cid))
        return out

    def _match_class(self, pattern: Term, cid: int,
                     sub: dict[str, int]) -> Iterator[dict[str, int]]:
        cid = self.find(cid)
        p_op = expr.op(pattern)
        if p_op.startswith("?"):
            bound = sub.get(p_op)
            if bound is None:
                s2 = dict(sub)
                s2[p_op] = cid
                yield s2
            elif self.find(bound) == cid:
                yield sub
            return
        for node in list(self.nodes_of(cid)):
            if node[0] != p_op or len(node) - 1 != len(expr.children(pattern)):
                continue
            yield from self._match_children(
                expr.children(pattern), node[1:], sub)

    def _match_children(self, pats, cids, sub) -> Iterator[dict[str, int]]:
        if not pats:
            yield sub
            return
        for s in self._match_class(pats[0], cids[0], sub):
            yield from self._match_children(pats[1:], cids[1:], s)

    def instantiate(self, pattern: Term, sub: dict[str, int]) -> int:
        p_op = expr.op(pattern)
        if p_op.startswith("?"):
            return self.find(sub[p_op])
        child_ids = [self.instantiate(c, sub) for c in expr.children(pattern)]
        return self.add_node(p_op, child_ids)

    # ---- extraction ----------------------------------------------------------

    def extract(
        self,
        root: int,
        cost_fn: Callable[[str, list[float]], float],
    ) -> Term:
        """Select min-cost e-node per class (bottom-up fixpoint), build term."""
        root = self.find(root)
        INF = float("inf")
        best_cost: dict[int, float] = {}
        best_node: dict[int, ENode] = {}
        changed = True
        rounds = 0
        while changed:
            changed = False
            rounds += 1
            if rounds > len(self.hashcons) + 10:
                break
            for cid, nodes in self.iter_classes():
                for node in sorted(nodes):  # deterministic tie-breaking
                    ccosts = [best_cost.get(self.find(c), INF) for c in node[1:]]
                    if any(c == INF for c in ccosts):
                        continue
                    c = cost_fn(node[0], ccosts)
                    if c < best_cost.get(cid, INF):
                        best_cost[cid] = c
                        best_node[cid] = node
                        changed = True
        if root not in best_node and root not in best_cost:
            raise ValueError("extraction failed: root class has no finite cost")

        def build(cid: int, depth: int = 0) -> Term:
            if depth > 10_000:
                raise RecursionError("cyclic extraction")
            node = best_node[self.find(cid)]
            return (node[0],) + tuple(build(c, depth + 1) for c in node[1:])

        return build(root)


# ---------------------------------------------------------------------------
# Rewrite driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rewrite:
    """Internal (egglog-style) rewrite: lhs pattern → rhs pattern.

    ``guard(egraph, sub)`` may veto a match (e.g. anchor protection).
    ``compute(egraph, sub)`` may return an rhs built programmatically
    (e.g. constant folding) instead of ``rhs``.
    """

    name: str
    lhs: Term
    rhs: Optional[Term] = None
    guard: Optional[Callable] = None
    compute: Optional[Callable] = None
    bidirectional: bool = False


def run_rewrites(
    eg: EGraph,
    rewrites: list[Rewrite],
    max_iters: int = 8,
) -> int:
    """Apply internal rewrites to saturation (or node limit).  Returns the
    number of successful rule applications (for Table-3-style stats)."""
    applied = 0
    for _ in range(max_iters):
        matches: list[tuple[Rewrite, dict, int, bool]] = []
        for rw in rewrites:
            for sub, cid in eg.ematch(rw.lhs):
                if rw.guard and not rw.guard(eg, sub):
                    continue
                matches.append((rw, sub, cid, False))
            if rw.bidirectional and rw.rhs is not None:
                for sub, cid in eg.ematch(rw.rhs):
                    if rw.guard and not rw.guard(eg, sub):
                        continue
                    matches.append((rw, sub, cid, True))
        changed = False
        for rw, sub, cid, rev in matches:
            if eg.n_nodes() > eg.node_limit:
                break
            if rw.compute is not None and not rev:
                new_id = rw.compute(eg, sub)
                if new_id is None:
                    continue
            else:
                pat = rw.lhs if rev else rw.rhs
                new_id = eg.instantiate(pat, sub)
            if eg.find(new_id) != eg.find(cid):
                eg.union(new_id, cid)
                applied += 1
                changed = True
        eg.rebuild()
        if not changed or eg.n_nodes() > eg.node_limit:
            break
    return applied
