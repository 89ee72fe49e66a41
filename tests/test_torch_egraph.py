"""The port's e-graph core (``repro_torch.core.{expr,egraph,rewrites,
matching,offload}``) against the reference's, on the CPU.

The reference's cases of ``tests/test_egraph.py`` run on the port's
modules with the same inputs.  Its hypothesis properties become fixed
draws from a seeded numpy generator (this container has no hypothesis),
and each saturation is also held to the reference's in the same process:
the same e-classes and e-nodes, and the same extracted term.  The
compilation counters of every trace program equal the reference's in one
process (they depend on Python's string hash seed, so never against a
file)."""

import numpy as np
import pytest

from repro.core import egraph as jeg
from repro.core import expr as jexpr
from repro.core.offload import compile_program as jcompile
from repro.core.rewrites import saturate_internal as jsaturate
from repro.targets import default_registry as jregistry
from repro_torch.core import expr
from repro_torch.core.egraph import EGraph, run_rewrites
from repro_torch.core.expr import const, var
from repro_torch.core.offload import compile_program, evaluate
from repro_torch.core.rewrites import internal_rules, saturate_internal
from repro_torch.targets import default_registry


class TestEGraphBasics:
    def test_hashcons_dedup(self):
        eg = EGraph()
        a = eg.add_term(("+", var("x"), const(1)))
        b = eg.add_term(("+", var("x"), const(1)))
        assert eg.find(a) == eg.find(b)

    def test_union_find(self):
        eg = EGraph()
        a = eg.add_term(var("a"))
        b = eg.add_term(var("b"))
        c = eg.add_term(var("c"))
        eg.union(a, b)
        eg.union(b, c)
        assert eg.find(a) == eg.find(c)

    def test_congruence_closure(self):
        eg = EGraph()
        fa = eg.add_term(("exp", var("a")))
        fb = eg.add_term(("exp", var("b")))
        assert eg.find(fa) != eg.find(fb)
        eg.union(eg.add_term(var("a")), eg.add_term(var("b")))
        eg.rebuild()
        assert eg.find(fa) == eg.find(fb)

    def test_congruence_two_levels(self):
        eg = EGraph()
        ffa = eg.add_term(("exp", ("neg", var("a"))))
        ffb = eg.add_term(("exp", ("neg", var("b"))))
        eg.union(eg.add_term(var("a")), eg.add_term(var("b")))
        eg.rebuild()
        assert eg.find(ffa) == eg.find(ffb)

    def test_ematch_binds_consistently(self):
        eg = EGraph()
        eg.add_term(("+", var("x"), var("x")))
        eg.add_term(("+", var("x"), var("y")))
        same = eg.ematch(("+", ("?a",), ("?a",)))
        assert len(same) == 1

    def test_extraction_minimizes(self):
        eg = EGraph()
        expensive = eg.add_term(("<<", var("i"), const(2)))
        cheap = eg.add_term(("*", var("i"), const(4)))
        eg.union(expensive, cheap)
        eg.rebuild()
        cost = lambda op, cc: (50.0 if op == "<<" else 1.0) + sum(cc)  # noqa: E731
        out = eg.extract(eg.find(expensive), cost)
        assert expr.op(out) == "*"

    def test_rewrite_nondestructive(self):
        """Union keeps both variants available (the e-graph accumulates)."""
        eg = EGraph()
        root = eg.add_term(("<<", var("i"), const(2)))
        run_rewrites(eg, internal_rules(), max_iters=3)
        nodes = {n[0] for n in eg.nodes_of(root)}
        assert "<<" in nodes and "*" in nodes


# --- the reference's properties, over fixed draws ---------------------------

_LEAVES = [var("x"), var("y"), const(2), const(3), const(5)]


def _term(rng, depth: int):
    """A term as the reference's ``_terms`` strategy draws them: a leaf, a
    binary +, * or -, or a shift by 1 or 2."""
    kind = rng.integers(0, 4) if depth else 0
    if kind == 0:
        return _LEAVES[rng.integers(0, len(_LEAVES))]
    if kind == 3:
        return ("<<", _term(rng, depth - 1), (const(1), const(2))[
            rng.integers(0, 2)])
    return ("+*-"[kind - 1], _term(rng, depth - 1), _term(rng, depth - 1))


TERMS = [_term(np.random.default_rng(seed), 3) for seed in range(60)]
CUNIT = lambda op, cc: 1.0 + sum(cc)  # noqa: E731


@pytest.mark.parametrize("seed", range(60))
def test_saturation_preserves_semantics(seed):
    """Any extraction from the saturated e-graph evaluates identically, and
    the port's saturation builds the reference's e-graph."""
    term = TERMS[seed]
    rng = np.random.default_rng(1000 + seed)
    env = {"x": np.int64(rng.integers(-3, 4)),
           "y": np.int64(rng.integers(-3, 4))}
    eg = EGraph(node_limit=20_000)
    root = eg.add_term(term)
    saturate_internal(eg, max_iters=3)
    got_term = eg.extract(eg.find(root), CUNIT)
    jg = jeg.EGraph(node_limit=20_000)
    jroot = jg.add_term(term)
    jsaturate(jg, max_iters=3)
    assert (eg.n_nodes(), eg.n_classes()) == (jg.n_nodes(), jg.n_classes())
    assert got_term == jg.extract(jg.find(jroot), CUNIT)
    try:
        want = evaluate(term, dict(env))
    except (ValueError, OverflowError):
        return  # invalid shifts
    got = evaluate(got_term, dict(env))
    assert np.allclose(np.float64(want), np.float64(got)), (term, got_term)


@pytest.mark.parametrize("seed", range(40))
def test_add_term_idempotent(seed):
    term = _term(np.random.default_rng(seed), 2)
    eg = EGraph()
    a = eg.add_term(term)
    b = eg.add_term(term)
    assert eg.find(a) == eg.find(b)
    n = eg.n_nodes()
    eg.add_term(term)
    assert eg.n_nodes() == n


@pytest.mark.parametrize("seed", range(30))
def test_union_symmetric_idempotent(seed):
    rng = np.random.default_rng(seed)
    t1, t2 = _term(rng, 2), _term(rng, 2)
    eg1 = EGraph()
    a1, b1 = eg1.add_term(t1), eg1.add_term(t2)
    eg1.union(a1, b1)
    eg1.rebuild()
    eg2 = EGraph()
    a2, b2 = eg2.add_term(t1), eg2.add_term(t2)
    eg2.union(b2, a2)
    eg2.union(a2, b2)
    eg2.rebuild()
    assert (eg1.find(a1) == eg1.find(b1)) == (eg2.find(a2) == eg2.find(b2))
    assert eg1.n_classes() == eg2.n_classes()


def test_normalize_indices_idempotent_and_alpha():
    t = expr.for_("k", const(0), const(8), const(1),
                  ("store", ("arr:A",), var("k"),
                   ("+", var("k"), var("free"))))
    n1 = expr.normalize_indices(t)
    n2 = expr.normalize_indices(n1)
    assert n1 == n2 == jexpr.normalize_indices(t)
    assert expr.op(n1) == "for:i0"
    leaves = {expr.op(u) for u in expr.walk(n1) if expr.is_leaf(u)}
    assert "var:free" in leaves and "var:i0" in leaves and "var:k" not in leaves


def test_loop_structure_summary():
    t = expr.for_("i", const(0), const(8), const(2),
                  expr.for_("j", const(0), const(4), const(1),
                            ("store", ("arr:A",), var("j"), var("j"))))
    s = expr.loop_structure(t)
    assert s == (4, 2, ((4, 1, ()),)) == jexpr.loop_structure(t)


# --- every trace program: the reference's compilation, in one process -------

KINDS = ["attention", "int8_matmul", "ssd_scan", "rmsnorm", "matmul", "fps",
         "ball_query", "group_aggregate"]


@pytest.mark.parametrize("kind", KINDS)
def test_trace_programs_compile_as_the_reference(kind):
    """The port's trace program is the reference's term, and saturation,
    matching and extraction over the full ISAX library give the
    reference's counters, matches and offloaded program."""
    prog = default_registry().spec_for_kind(kind).trace_program()
    jprog = jregistry().spec_for_kind(kind).trace_program()
    assert prog == jprog
    got = compile_program(prog, default_registry().isaxes(), case=kind)
    want = jcompile(jprog, jregistry().isaxes(), case=kind)
    g, w = got.stats, want.stats
    assert (g.internal_rewrites, g.external_rewrites, g.initial_enodes,
            g.saturated_enodes, g.matched_isaxes) == (
        w.internal_rewrites, w.external_rewrites, w.initial_enodes,
        w.saturated_enodes, w.matched_isaxes)
    assert got.program == want.program
