"""The port's ISAX/domain registry (``repro_torch.targets``) and its
retargetable compilation (``core.offload``) against the reference's, on
the CPU.

The reference's cases of ``tests/test_targets.py`` and
``tests/test_offload.py`` run on the port's modules with the same inputs:
registration invariants, the golden keys, the trace memo keyed by spec
identity, a toy third domain of the port's own plugged in through
``register_domain`` and dispatched by the unchanged engine, the
syntactic variants that must still match, and offloaded programs that
evaluate equal to their software programs — with the port's intrinsics
(``kernels/ops.kernel_intrinsics``, ``pointcloud/ops.pointcloud_intrinsics``
on the CPU: the kernel routes' plain versions) for all seven target
ISAXes.  Each compilation is also held to the reference's in the same
process (counters, matches, the offloaded term)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.compile.trace import trace_kind as jtrace_kind
from repro.compile.trace import trace_term as jtrace_term
from repro.core.offload import compile_program as jcompile
from repro.targets import default_registry as jregistry
from repro_torch.compile import Dispatcher, LoweringConfig, OpKey
from repro_torch.compile.trace import trace_kind, trace_term
from repro_torch.core import expr
from repro_torch.core.expr import arr, const, for_, var
from repro_torch.core.matching import ISAX, decompose
from repro_torch.core import offload
from repro_torch.core.offload import compile_program, evaluate
from repro_torch.core.rewrites import internal_rules
from repro_torch.core.tiling import down_pow2
from repro_torch.kernels.ops import (kernel_intrinsics,
                                     register_kernel_intrinsics)
from repro_torch.pointcloud.ops import (pointcloud_intrinsics,
                                        register_pointcloud_intrinsics)
from repro_torch.targets import (cases, default_registry, isax_library,
                                 registry)
from repro_torch.targets import llm as llm_domain
from repro_torch.targets import pointcloud as pc_domain
from repro_torch.targets.llm import (isax_flash_attention, isax_int8_matvec,
                                     isax_rmsnorm, isax_ssd_step, isax_swiglu)
from repro_torch.targets.registry import (DomainPackage, IsaxSpec,
                                          TargetRegistry)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "dispatch_records.json"
INTRINSICS = {**kernel_intrinsics("cpu"), **pointcloud_intrinsics("cpu")}


# ---------------------------------------------------------------------------
# a toy third domain of the port's own, in one place: O[i] = a·X[i] + Y[i],
# spelled commuted twice so that matching needs add-comm and mul-comm
# ---------------------------------------------------------------------------

def _axpy_program():
    i = var("i")
    return for_("i", const(0), var("n"), const(1),
                ("store", arr("Oy"), i,
                 ("+", ("load", arr("Y"), i),
                  ("*", ("load", arr("X"), i), var("a")))))


def isax_axpy() -> ISAX:
    i = var("i")
    term = for_("i", const(0), var("n"), const(1),
                ("store", arr("Oy"), i,
                 ("+", ("*", var("a"), ("load", arr("X"), i)),
                  ("load", arr("Y"), i))))
    return ISAX(name="axpy", params=("X", "Y", "a", "n", "Oy"), term=term,
                kernel="axpy", outputs=("Oy",))


def _np_axpy(X, Y, a, n, Oy):
    Oy[:] = a * X + Y


def axpy_kernel(x, y, a, *, schedule=None):
    """The toy's "kernel": torch ops stand in (the dispatch contract only
    needs a bound callable)."""
    return a * torch.as_tensor(x) + torch.as_tensor(y)


TOY = DomainPackage(
    name="toy", description="A third domain in one place.",
    specs=(IsaxSpec(
        name="axpy", isax=isax_axpy, evaluator=_np_axpy, trace_kind="axpy",
        trace_program=_axpy_program, ops=("axpy",),
        rewrites=("add-comm", "mul-comm"),
        scheduler=lambda key: ({"block_rows": down_pow2(key.shape[0], 128)},
                               "ok"),
        kernel=axpy_kernel,
        description="Scaled row accumulate O[i] = a·X[i] + Y[i]."),))


# ---------------------------------------------------------------------------
# (a) registration invariants
# ---------------------------------------------------------------------------

class TestRegistration:
    def test_builtin_domains_loaded_in_order(self):
        reg = default_registry()
        assert list(reg.domains()) == ["llm", "pointcloud"]
        assert [i.name for i in reg.isaxes()] == [
            i.name for i in jregistry().isaxes()] == [
            "flash_attention", "int8_matvec", "ssd_step", "rmsnorm",
            "swiglu", "fps", "ball_query", "group_agg"]
        assert reg.ops() == jregistry().ops()

    def test_duplicate_domain_rejected(self):
        reg = TargetRegistry()
        reg.register(llm_domain.DOMAIN)
        with pytest.raises(ValueError, match="already registered"):
            reg.register(llm_domain.DOMAIN)

    def test_duplicate_spec_name_rejected(self):
        reg = TargetRegistry()
        reg.register(llm_domain.DOMAIN)
        clash = DomainPackage("other", (dataclasses.replace(
            llm_domain.DOMAIN.specs[0], domain=None),))
        with pytest.raises(ValueError, match="duplicate ISAX spec name"):
            reg.register(clash)
        assert "other" not in reg.domains()

    def test_duplicate_op_rejected(self):
        reg = TargetRegistry()
        reg.register(llm_domain.DOMAIN)
        spec = dataclasses.replace(TOY.specs[0], ops=("attention",),
                                   domain=None)
        with pytest.raises(ValueError, match="duplicate dispatch op"):
            reg.register(DomainPackage("other", (spec,)))

    def test_incomplete_spec_rejected(self):
        broken = dataclasses.replace(TOY.specs[0], kernel=None, domain=None)
        with pytest.raises(ValueError, match="kernel entry point"):
            TargetRegistry().register(DomainPackage("b", (broken,)))
        unnamed = dataclasses.replace(TOY.specs[0], name="", domain=None)
        with pytest.raises(ValueError, match="non-empty name"):
            TargetRegistry().register(DomainPackage("b", (unnamed,)))

    def test_every_dispatchable_spec_resolves(self):
        for spec in default_registry().specs():
            spec.validate()
            if not spec.ops:
                continue
            assert spec.trace_program() is not None
            if spec.isax is None:
                continue
            assert callable(spec.scheduler) and callable(spec.kernel)
            assert callable(spec.evaluator)
            assert spec.isax().name == spec.name

    def test_declared_rewrites_exist(self):
        names = {r.name for r in internal_rules()}
        for spec in default_registry().specs():
            assert not set(spec.rewrites) - names, spec.name

    def test_specs_mirror_the_references(self):
        """Each spec carries the reference's trace program, ISAX term, ops,
        rewrites and trace kind; kernels are the port's routes."""
        for spec in default_registry().specs():
            ref = jregistry().spec(spec.name)
            assert (spec.ops, spec.rewrites, spec.trace_kind, spec.target) \
                == (ref.ops, ref.rewrites, ref.trace_kind, ref.target)
            if spec.trace_program:
                assert spec.trace_program() == ref.trace_program()
            if spec.isax:
                mine, theirs = spec.isax(), ref.isax()
                assert (mine.term, mine.params, mine.outputs) == (
                    theirs.term, theirs.params, theirs.outputs)
            assert spec.kernel is None or spec.kernel.__module__.startswith(
                "repro_torch.")


def test_golden_keys_extract_as_the_golden_records():
    golden = json.loads(GOLDEN.read_text())
    assert len(golden) == 11
    disp = Dispatcher()
    for want in golden:
        rec = disp.lower(OpKey(want["op"], tuple(want["shape"]),
                               want["dtype"], "cuda"))
        assert (rec.impl, list(rec.matched), rec.target) == (
            want["impl"], want["matched"], want["target"]), want["op"]
        assert (rec.outcome.internal_rewrites > 0) == (
            want["internal_rewrites"] > 0)


def test_cache_key_roundtrip_unchanged():
    disp = Dispatcher()
    a = disp.lower(OpKey("fps", (1, 256, 64), "float32", "cuda"))
    b = disp.lower(OpKey("fps", (1, 256, 64), "float32", "cuda"))
    assert a is b and disp.hits == 1


def test_trace_memo_keyed_by_spec_identity():
    """Two domains reusing a trace-kind string get independent saturation
    runs."""
    toy_a = dataclasses.replace(TOY.specs[0], domain=None)
    other = IsaxSpec(name="not_axpy", trace_kind="axpy",
                     trace_program=default_registry().spec(
                         "matmul").trace_program, ops=("not_axpy",))
    reg = TargetRegistry()
    reg.register(DomainPackage("toy", (toy_a,)))
    reg.register(DomainPackage("other", (other,)))
    disp = Dispatcher(registry=reg)
    rec_a = disp.lower(OpKey("axpy", (8, 8), "float32", "cuda"))
    rec_b = disp.lower(OpKey("not_axpy", (8, 8), "float32", "cuda"))
    assert len(disp._outcomes) == 2
    assert "axpy" in rec_a.matched
    assert rec_b.matched == () and rec_b.impl == "reference"


# ---------------------------------------------------------------------------
# (b) the toy third domain through the unchanged engine
# ---------------------------------------------------------------------------

class TestToyDomain:
    @pytest.fixture()
    def lowering(self):
        reg = TargetRegistry()
        reg.register(llm_domain.DOMAIN)
        reg.register(pc_domain.DOMAIN)
        reg.register(TOY)
        return LoweringConfig.from_registry("cuda", registry=reg)

    def test_matched_scheduled_cached_dispatched(self, lowering):
        rec = lowering.lower("axpy", (64, 16), "float32")
        assert rec.impl == "isax", rec.note
        assert "axpy" in rec.matched
        assert rec.schedule == {"block_rows": 64}
        assert rec.kernel_fn is axpy_kernel
        assert lowering.lower("axpy", (64, 16), "float32") is rec
        assert lowering.dispatcher.hits == 1

    def test_kernel_parity_through_dispatch(self, lowering):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 16)).astype(np.float32)
        y = rng.normal(size=(64, 16)).astype(np.float32)
        rec = lowering.lower("axpy", (64, 16), "float32")
        got = rec.kernel_fn(x, y, 0.5, schedule=rec.schedule).numpy()
        np.testing.assert_allclose(got, 0.5 * x + y, rtol=1e-6)

    def test_evaluator_parity(self, lowering):
        rng = np.random.default_rng(1)
        e_sw = dict(X=rng.normal(size=(8, 4)), Y=rng.normal(size=(8, 4)),
                    a=0.25, n=8, Oy=np.zeros((8, 4)))
        e_hw = cases.copy_env(e_sw)
        res = compile_program(_axpy_program(), lowering.registry.isaxes(),
                              case="toy")
        assert "axpy" in res.stats.matched_isaxes
        evaluate(_axpy_program(), e_sw)
        evaluate(res.program, e_hw,
                 intrinsics=lowering.registry.evaluators())
        np.testing.assert_allclose(e_sw["Oy"], e_hw["Oy"], atol=1e-12)

    def test_global_registry_untouched(self, lowering):
        assert not default_registry().has_op("axpy")
        assert len(isax_library()) == 8

    def test_register_domain_appends_to_the_global_registry(self,
                                                            monkeypatch):
        """``register_domain`` loads the built-in domains first, then the
        new one, and the default dispatcher matches and extracts it."""
        monkeypatch.setattr(registry, "_REGISTRY", TargetRegistry())
        monkeypatch.setattr(registry, "_BUILTINS_LOADED", False)
        registry.register_domain(TOY)
        reg = registry.default_registry()
        assert list(reg.domains()) == ["llm", "pointcloud", "toy"]
        assert [i.name for i in reg.isaxes()][-1] == "axpy"
        rec = Dispatcher().lower(OpKey("axpy", (16, 8), "float32", "cuda"))
        assert rec.impl == "isax" and rec.kernel_fn is axpy_kernel


# ---------------------------------------------------------------------------
# (c) compilation robustness (tests/test_offload.py's cases)
# ---------------------------------------------------------------------------

def _same_as_reference(sw, isaxes, case):
    """Compile ``sw`` with the port and with the reference in one process;
    the two must agree on counters, matches and the offloaded term."""
    res = compile_program(sw, isaxes, case=case)
    jres = jcompile(sw, [jregistry().spec(i.name).isax() for i in isaxes],
                    case=case)
    s, j = res.stats, jres.stats
    assert (s.internal_rewrites, s.external_rewrites, s.initial_enodes,
            s.saturated_enodes, s.matched_isaxes) == (
        j.internal_rewrites, j.external_rewrites, j.initial_enodes,
        j.saturated_enodes, j.matched_isaxes)
    assert res.program == jres.program
    return res


def _run_both(sw, result, env_fn, outs, atol=1e-5):
    e0, e1 = env_fn(), env_fn()
    evaluate(sw, e0)
    evaluate(result.program, e1, intrinsics=INTRINSICS)
    for o in outs:
        np.testing.assert_allclose(e0[o], e1[o], atol=atol, rtol=1e-4)


def _mv_body(iexpr):
    return ("store", arr("C"), iexpr,
            ("*", var("s_w"), ("matvec", arr("Wq"), ("load", arr("X"),
                                                     iexpr))))


def _mv_env(n=8, m=5, k2=7, seed=1):
    rng = np.random.default_rng(seed)
    return dict(Wq=rng.integers(-127, 127, size=(m, k2)).astype(np.int8),
                X=rng.normal(size=(n, k2)).astype(np.float32).astype(
                    np.float64), s_w=0.02, n=n, C=np.zeros((n, m)))


class TestInt8Matvec:
    def test_exact_match(self):
        res = _same_as_reference(isax_int8_matvec().term,
                                 [isax_int8_matvec()], "exact")
        assert res.stats.matched_isaxes == ["int8_matvec"]

    def test_unrolled_variant(self):
        sw = for_("i", const(0), const(8), const(2),
                  _mv_body(var("i")), _mv_body(("+", var("i"), const(1))))
        res = _same_as_reference(sw, [isax_int8_matvec()], "unrolled")
        assert "int8_matvec" in res.stats.matched_isaxes
        assert res.stats.external_rewrites >= 1
        _run_both(sw, res, _mv_env, ["C"])

    def test_tiled_variant(self):
        inner = for_("j", var("it"), ("+", var("it"), const(4)), const(1),
                     _mv_body(var("j")))
        sw = for_("it", const(0), const(8), const(4), inner)
        res = _same_as_reference(sw, [isax_int8_matvec()], "tiled")
        assert "int8_matvec" in res.stats.matched_isaxes
        _run_both(sw, res, _mv_env, ["C"])

    def test_shifted_index_variant(self):
        body = ("store", arr("C"), var("i"),
                ("*", var("s_w"),
                 ("matvec", arr("Wq"),
                  ("load", arr("X"), (">>", ("<<", var("i"), const(1)),
                                      const(1))))))
        sw = for_("i", const(0), var("n"), const(1), body)
        res = _same_as_reference(sw, [isax_int8_matvec()], "shifted")
        assert "int8_matvec" in res.stats.matched_isaxes

    def test_scale_position_variant(self):
        body = ("store", arr("C"), var("i"),
                ("matvec", arr("Wq"),
                 ("*", var("s_w"), ("load", arr("X"), var("i")))))
        sw = for_("i", const(0), var("n"), const(1), body)
        res = _same_as_reference(sw, [isax_int8_matvec()], "scale-moved")
        assert "int8_matvec" in res.stats.matched_isaxes

    def test_non_matching_program_is_untouched(self):
        body = ("store", arr("C"), var("i"),
                ("+", ("load", arr("C"), var("i")),
                 ("*", var("s_w"), ("matvec", arr("Wq"),
                                    ("load", arr("X"), var("i"))))))
        sw = for_("i", const(0), var("n"), const(1), body)
        res = _same_as_reference(sw, [isax_int8_matvec()], "negative")
        assert "int8_matvec" not in res.stats.matched_isaxes


class TestFlashAttentionSsdRmsnormSwiglu:
    def test_softmax_shift_and_scale_variants_match(self):
        sw = default_registry().spec("flash_attention").trace_program()
        res = _same_as_reference(sw, [isax_flash_attention()], "attn")
        assert res.stats.matched_isaxes == ["flash_attention"]
        assert expr.op(res.program).startswith("isax:")
        _run_both(sw, res, lambda: cases.environment("attention"), ["O", "P"])

    def test_ssd_loop_carried_dependence_and_numerics(self):
        ix = isax_ssd_step()
        res = _same_as_reference(ix.term, [ix], "ssd")
        assert res.stats.matched_isaxes == ["ssd_step"]
        _run_both(ix.term, res, lambda: cases.environment("ssd_scan"),
                  ["Y", "H"])

    def test_rmsnorm_match_and_numerics(self):
        ix = isax_rmsnorm()
        res = _same_as_reference(ix.term, [ix], "rms")
        assert res.stats.matched_isaxes == ["rmsnorm"]
        _run_both(ix.term, res, lambda: cases.environment("rmsnorm"), ["On"])

    def test_swiglu_sigmoid_form_variants_match(self):
        ix = isax_swiglu()
        i = var("i")
        x = ("load", arr("Xs"), i)
        g = ("matvec", arr("Wg"), x)
        u = ("matvec", arr("Wu"), x)
        silu2 = ("*", g, ("recip", ("+", ("const:1",), ("exp", ("neg", g)))))
        sw = for_("i", const(0), var("n"), const(1),
                  ("store", arr("Os"), i,
                   ("matvec", ("transpose", arr("Wo")), ("*", silu2, u))))
        res = _same_as_reference(sw, [ix], "swiglu-recip")
        assert res.stats.matched_isaxes == ["swiglu"]

        def env():
            r = np.random.default_rng(0)
            return dict(Wg=r.normal(size=(12, 8)), Wu=r.normal(size=(12, 8)),
                        Wo=r.normal(size=(12, 8)), Xs=r.normal(size=(4, 8)),
                        n=4, Os=np.zeros((4, 8)))

        _run_both(sw, res, env, ["Os"])

    def test_table3_stats_and_the_library_does_not_cross_fire(self):
        sw = for_("i", const(0), const(8), const(2),
                  _mv_body(var("i")), _mv_body(("+", var("i"), const(1))))
        s = _same_as_reference(sw, [isax_int8_matvec()], "stats").stats
        assert s.saturated_enodes >= s.initial_enodes > 0
        assert s.internal_rewrites > 0 and s.saturated_enodes < 60_000
        res = _same_as_reference(isax_rmsnorm().term, isax_library(),
                                 "library")
        assert res.stats.matched_isaxes == ["rmsnorm"]

    def test_decompose_skeleton_components(self):
        skel = decompose(isax_flash_attention())
        assert len(skel.components) == 2
        assert expr.op(skel.pattern).startswith("for:")
        assert skel.loop_struct is not None
        deps = [c.self_dep_array for c in decompose(isax_ssd_step()).components]
        assert "H" in deps


@pytest.mark.parametrize("kind", list(cases.CASES))
def test_offloaded_program_evaluates_as_the_software_program(kind):
    """For each of the seven target ISAXes: its trace program (the
    software spelling) compiles to one that calls the ISAX, and with the
    port's intrinsics the offloaded program's outputs equal the software
    program's (indices and the max-pool exactly, floats at
    ``cases.FLOAT_TOL``)."""
    isax, _, _ = cases.CASES[kind]
    prog = default_registry().spec_for_kind(kind).trace_program()
    res = _same_as_reference(prog, default_registry().isaxes(), kind)
    assert isax in res.stats.matched_isaxes
    assert f"isax:{isax}" in {expr.op(t) for t in expr.walk(res.program)}
    env = cases.environment(kind)
    hw = cases.copy_env(env)
    evaluate(prog, env)
    evaluate(res.program, hw, intrinsics=INTRINSICS)
    cases.compare(kind, env, hw)


def test_trace_kind_and_term_equal_the_reference():
    """``compile.trace.trace_kind`` for every dispatch op and
    ``trace_term`` for every kind print as the reference's."""
    reg = default_registry()
    assert reg.ops() == jregistry().ops()
    for op in reg.ops():
        assert trace_kind(op) == jtrace_kind(op)
    kinds = {trace_kind(op) for op in reg.ops()}
    assert kinds == {"attention", "int8_matmul", "ssd_scan", "rmsnorm",
                     "matmul", "fps", "ball_query", "group_aggregate"}
    for kind in sorted(kinds):
        assert repr(trace_term(kind)) == repr(jtrace_term(kind)), kind


INTRINSIC_FACTORIES = (kernel_intrinsics, register_kernel_intrinsics,
                       pointcloud_intrinsics, register_pointcloud_intrinsics)


def test_intrinsics_default_to_the_card(monkeypatch):
    """With no card visible the intrinsics refuse the default device (the
    card) rather than compute on the CPU; asked for the CPU they register
    the plain versions, which evaluate each offloaded program as the
    software program."""
    monkeypatch.setattr(offload, "_INTRINSICS", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for factory in INTRINSIC_FACTORIES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory("cuda")
    assert offload._INTRINSICS == {}
    register_kernel_intrinsics("cpu")
    register_pointcloud_intrinsics("cpu")
    assert set(offload._INTRINSICS) == set(INTRINSICS)
    for kind in cases.CASES:
        prog = default_registry().spec_for_kind(kind).trace_program()
        res = compile_program(prog, default_registry().isaxes(), case=kind)
        env = cases.environment(kind)
        hw = cases.copy_env(env)
        evaluate(prog, env)
        evaluate(res.program, hw)
        cases.compare(kind, env, hw)

