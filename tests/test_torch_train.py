"""The port's training substrate against the JAX package, in one process.

``TokenPipeline`` batches bit-equal to the reference's (both sources, vlm
and encdec); ``warmup_cosine``; ``compress_int8`` (a tie rounds half to
even, and the reference's error-feedback property); one ``apply_updates``
against the reference's at the fp32 tolerance (fp32 and bf16 state, with
and without compression); the port's ``Trainer`` against the reference's
from the same initial weights; checkpoints read by the other package bit
for bit, digests included, and a reference checkpoint resumed by the
port's trainer; the mirrors of ``tests/test_train.py``; and the examples
with ``jax`` and ``repro`` unimportable.

Trajectory tolerance: rtol 1e-4 on the loss and on ``grad_norm`` over 12
steps (the restart test's bound; 1e-3 would be loose).  Both run fp32 from
the same weights and batches; they differ only in the order of fp32 sums
(GEMMs, reductions), ≈1e-7 relative a step, which AdamW's normalised
steps (lr 1e-3) carry forward without growth over 12 steps: the largest
relative difference seen on this CPU is 2.5e-7.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

if os.environ.get("CI", "").lower() not in ("", "0", "false"):
    import hypothesis  # noqa: F401
else:
    pytest.importorskip(
        "hypothesis", reason="install the dev extra: pip install -e .[dev]")
from hypothesis import given, settings, strategies as st

import torch

from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import checkpoint as jckpt
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.compile import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.registry import get_model
from repro_torch.optim import schedule
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     compress_int8, init_state)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               StragglerMonitor,
                                               run_with_restarts)
from repro_torch.train.trainer import TrainConfig, Trainer, loss_and_grads
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = reduced(get_config("llama110m"))
JCFG = jax_reduced(jax_get_config("llama110m"))
TOL = dict(atol=2e-5, rtol=2e-4)
TRAJ_RTOL = 1e-4

_INIT: dict = {}


def _ref_init():
    """The reference Trainer's initial weights (seed 0) as a port tree."""
    if "p" not in _INIT:
        jp = jax_get_model(JCFG).init(jax.random.key(0))
        _INIT["p"] = params_from_numpy(jax.tree.map(np.asarray, jp))
    return _INIT["p"]


def _trainer(tc, **kw):
    return Trainer(CFG, tc, params=_ref_init(), device="cpu", **kw)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,source", [
    ("llama110m", "synthetic"), ("llama110m", "file"),
    ("paligemma-3b", "synthetic"), ("seamless-m4t-medium", "synthetic"),
    ("zamba2-1.2b", "file")])
def test_pipeline_bit_equal_to_reference(arch, source, tmp_path):
    path = None
    if source == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(7).integers(0, 65535, 5000).astype(
            np.uint16).tofile(path)
    cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    for seed in (0, 3, 12345):
        mine = TokenPipeline(cfg, 3, 24, PipelineConfig(seed, source, path))
        ref = JaxTokenPipeline(jcfg, 3, 24,
                               JaxPipelineConfig(seed, source, path))
        for step in (0, 1, 7, 1000):
            got, want = mine.get_batch(step), ref.get_batch(step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if cfg.family == "vlm":
        assert got["tokens"].shape == (3, 24 - cfg.n_prefix_tokens)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_reference():
    steps = np.array([0, 1, 5, 19, 20, 21, 100, 500, 999, 1000, 1500])
    for warmup, total in ((20, 1000), (0, 10), (100, 10_000)):
        got = schedule.warmup_cosine(torch.from_numpy(steps), warmup=warmup,
                                     total=total)
        want = jschedule.warmup_cosine(jnp.asarray(steps), warmup=warmup,
                                       total=total)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for s in (0, 7, 20):  # a plain int and an int32 0-d tensor
            assert float(schedule.warmup_cosine(s, warmup=warmup,
                                                total=total)) == \
                pytest.approx(float(jschedule.warmup_cosine(
                    s, warmup=warmup, total=total)), rel=1e-6, abs=1e-7)
    assert float(schedule.constant(torch.tensor(5, dtype=torch.int32))) == 1.0


def test_compress_int8_rounds_ties_half_to_even():
    """max|g| = 127 makes the scale exactly 1, so ±0.5, 1.5, 2.5 are ties:
    they round to 0, 2, 2 as ``jnp.round`` does."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                 dtype=np.float32)
    deq, err = compress_int8(torch.from_numpy(g), torch.zeros(8))
    jdeq, jerr = jadamw.compress_int8(jnp.asarray(g), jnp.zeros(8))
    np.testing.assert_array_equal(
        deq.numpy(), [127, 0, 2, 2, 0, -2, -2, 4])
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def _opt_inputs(seed: int, big: bool):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(16, 8)).astype(np.float32),
              "b": {"c": rng.normal(size=(33,)).astype(np.float32)}}
    scale = 3.0 if big else 0.01  # clipping active / not
    grads = tree_map(lambda p: (rng.normal(size=p.shape) * scale).astype(
        np.float32), params)
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_reference(state_dtype, compress):
    """Two steps from the same params, gradients and zero state: params,
    moments, error feedback, step and grad_norm at the fp32 tolerance
    (bf16 moments compared in bf16: both round the same fp32 value)."""
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype,
                      compress_grads=compress)
    jcfg = jadamw.AdamWConfig(lr=1e-2, state_dtype=state_dtype,
                              compress_grads=compress)
    np_params, _ = _opt_inputs(0, True)
    # copies: apply_updates writes in place, and jnp.asarray may share
    # the numpy buffer
    params = tree_map(lambda a: torch.from_numpy(a.copy()), np_params)
    jparams = jax.tree.map(jnp.array, np_params)
    state, jstate = init_state(params, cfg), jadamw.init_state(jparams, jcfg)
    for step, big in ((0, True), (1, False)):
        _, np_grads = _opt_inputs(step + 1, big)
        params, state, m = apply_updates(
            params, tree_map(torch.from_numpy, np_grads), state, cfg,
            lr_scale=0.5)
        jparams, jstate, jm = jadamw.apply_updates(
            jparams, jax.tree.map(jnp.asarray, np_grads), jstate, jcfg,
            lr_scale=0.5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        assert sorted(state) == sorted(jstate)
        for k in ("m", "v", "err"):
            if k in jstate:
                for got, want in zip(jax.tree.leaves(jstate[k]),
                                     tree_leaves(state[k])):
                    assert str(got.dtype) == str(want.dtype).removeprefix(
                        "torch.")
                    np.testing.assert_allclose(
                        want.float().numpy(), np.asarray(got, np.float32),
                        **TOL, err_msg=k)
        for got, want in zip(tree_leaves(params),
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# mirrors of tests/test_train.py ------------------------------------------

class TestOptimizer:
    def test_adamw_decreases_loss(self):
        model = get_model(CFG, lowering=LoweringConfig("torch"))
        params = model.init(0, "cpu")
        opt_cfg = AdamWConfig(lr=1e-2)
        state = init_state(params, opt_cfg)
        pipe = TokenPipeline(CFG, 4, 32)
        batch = {k: torch.from_numpy(v) for k, v in pipe.get_batch(0).items()}
        loss0, _ = loss_and_grads(model, params, batch)
        for _ in range(8):
            _, g = loss_and_grads(model, params, batch)
            params, state, _ = apply_updates(params, g, state, opt_cfg)
        assert float(loss_and_grads(model, params, batch)[0]) < float(loss0)

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_compression_error_feedback_bounded(self, seed):
        """|deq − (g+err)| ≤ scale/2 and deq + new_err = g (property)."""
        rng = np.random.default_rng(seed)
        g = torch.from_numpy(rng.normal(size=(32,)) * rng.uniform(0.01, 10))
        err = torch.zeros_like(g)
        deq, new_err = compress_int8(g, err)
        scale = float(torch.max(torch.abs(g))) / 127.0
        assert float(torch.max(torch.abs(deq - g))) <= scale / 2 + 1e-6
        np.testing.assert_allclose((deq + new_err).numpy(), g.numpy(),
                                   atol=1e-6)

    def test_grad_clipping(self):
        p = {"w": torch.ones(4)}
        g = {"w": torch.full((4,), 100.0)}
        cfg = AdamWConfig(clip_norm=1.0, lr=0.0, weight_decay=0.0)
        s = init_state(p, cfg)
        _, _, m = apply_updates(p, g, s, cfg)
        assert float(m["grad_norm"]) == pytest.approx(200.0)


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(5, dtype=torch.float32),
                "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
        ckpt.save(str(tmp_path), 7, tree)
        loaded, manifest = ckpt.load(str(tmp_path), verify=True)
        assert manifest["step"] == 7
        np.testing.assert_array_equal(loaded["a"].numpy(),
                                      np.arange(5, dtype=np.float32))
        assert loaded["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(loaded["b"]["c"], tree["b"]["c"])

    def test_latest_skips_corrupted(self, tmp_path):
        tree = {"a": torch.arange(3)}
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, tree)
        for f in os.listdir(tmp_path / "ckpt_2"):
            if f.endswith(".npy"):
                os.remove(tmp_path / "ckpt_2" / f)
        assert ckpt.latest_step(str(tmp_path)) == 1

    def test_atomic_commit_no_partial(self, tmp_path):
        tree = {"a": torch.arange(3)}
        ckpt.save(str(tmp_path), 1, tree)
        os.makedirs(tmp_path / "ckpt_9.tmp")
        assert ckpt.latest_step(str(tmp_path)) == 1

    def test_gc_keeps_newest(self, tmp_path):
        tree = {"a": torch.arange(3)}
        for s in (1, 2, 3, 4):
            ckpt.save(str(tmp_path), s, tree)
        ckpt.gc(str(tmp_path), keep=2)
        assert ckpt.steps(str(tmp_path)) == [3, 4]

    def test_digest_mismatch_raises(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"a": torch.arange(4.0)})
        np.save(tmp_path / "ckpt_1" / "a.npy", np.arange(4.0, 8.0,
                                                         dtype=np.float32))
        ckpt.load(str(tmp_path))  # no verify: loads
        with pytest.raises(IOError, match="digest mismatch"):
            ckpt.load(str(tmp_path), verify=True)


class TestFaultTolerance:
    def test_restart_resumes_exactly(self, tmp_path):
        """An injected failure at step 7 under run_with_restarts: all 12
        steps run, and the post-restart losses equal a no-failure run's."""
        tc = TrainConfig(batch=4, seq=32, ckpt_dir=str(tmp_path),
                         ckpt_every=5, total_steps=12,
                         optimizer=AdamWConfig(lr=1e-3))
        inj = FailureInjector({7})
        built = []

        def make():
            built.append(1)
            return Trainer(CFG, tc, failure_injector=inj, device="cpu")

        trainer = run_with_restarts(make, total_steps=12)
        assert trainer.step == 12 and len(built) == 2
        assert [m["step"] for m in trainer.metrics_log] == list(range(5, 12))
        tc2 = TrainConfig(batch=4, seq=32, ckpt_dir=None, total_steps=12,
                          optimizer=AdamWConfig(lr=1e-3))
        ref = Trainer(CFG, tc2, device="cpu")
        ref.train(12)
        ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
        for m in trainer.metrics_log:
            assert m["loss"] == pytest.approx(ref_losses[m["step"]],
                                              rel=1e-4), m["step"]

    def test_async_checkpoint_roundtrip(self, tmp_path):
        tc = TrainConfig(batch=4, seq=32, ckpt_dir=str(tmp_path),
                         ckpt_every=4, total_steps=8, async_ckpt=True,
                         optimizer=AdamWConfig(lr=1e-3))
        tr = Trainer(CFG, tc, device="cpu")
        tr.train(8)
        assert ckpt.latest_step(str(tmp_path)) == 8
        tree, _ = ckpt.load(str(tmp_path), verify=True)
        assert torch.equal(tree["params"]["embed"]["table"],
                           tr.params["embed"]["table"])

    def test_async_snapshot_taken_before_later_steps(self, tmp_path):
        """The step-4 checkpoint holds step 4's weights, though the writer
        thread may run while steps 5-7 update the live tensors in place."""
        tc = TrainConfig(batch=4, seq=32, ckpt_dir=str(tmp_path),
                         ckpt_every=4, keep_ckpts=5, total_steps=8,
                         async_ckpt=True, optimizer=AdamWConfig(lr=1e-3))
        tr = Trainer(CFG, tc, device="cpu")
        tr.train(4)
        at4 = tr.params["embed"]["table"].clone()
        tr.train(8)
        tree, _ = ckpt.load(str(tmp_path), step=4, verify=True)
        assert torch.equal(tree["params"]["embed"]["table"], at4)
        assert not torch.equal(at4, tr.params["embed"]["table"])

    def test_straggler_monitor(self):
        mon = StragglerMonitor(window=20, z_threshold=5.0, min_samples=5)
        for i in range(10):
            assert mon.record(i, 0.1 + 0.001 * (i % 3)) is None
        ev = mon.record(10, 2.0)
        assert ev is not None and ev.z > 5

    def test_injector_fires_once(self):
        inj = FailureInjector({3})
        with pytest.raises(RuntimeError):
            inj.maybe_fail(3)
        inj.maybe_fail(3)

    def test_restarts_are_bounded(self):
        def make():
            class Failing:
                def train(self, n):
                    raise RuntimeError("down")
            return Failing()
        with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
            run_with_restarts(make, 5, max_restarts=2)


class TestDataPipeline:
    def test_deterministic_per_step(self):
        p1 = TokenPipeline(CFG, 4, 32, PipelineConfig(seed=1))
        p2 = TokenPipeline(CFG, 4, 32, PipelineConfig(seed=1))
        b1, b2 = p1.get_batch(5), p2.get_batch(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(b1["tokens"], p1.get_batch(6)["tokens"])

    def test_labels_shifted(self):
        b = TokenPipeline(CFG, 2, 16).get_batch(0)
        assert b["tokens"].shape == b["labels"].shape
        assert (b["tokens"] < CFG.vocab).all()
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_vlm_prefix(self):
        cfg = reduced(get_config("paligemma-3b"))
        b = TokenPipeline(cfg, 2, 16).get_batch(0)
        assert b["prefix_embeds"].shape == (2, cfg.n_prefix_tokens,
                                            cfg.d_model)

    def test_file_source_needs_a_path(self):
        with pytest.raises(ValueError, match="path"):
            TokenPipeline(CFG, 2, 16, PipelineConfig(source="file"))


# ---------------------------------------------------------------------------
# The Trainer against the reference's
# ---------------------------------------------------------------------------

def _run_ref(tc_kw, steps, ckpt_dir=None):
    tc = JaxTrainConfig(ckpt_dir=ckpt_dir, **tc_kw,
                        optimizer=jadamw.AdamWConfig(lr=1e-3))
    tr = JaxTrainer(JCFG, tc)
    tr.train(steps)
    return tr


TRAJ = dict(batch=4, seq=32, total_steps=12, ckpt_every=6)


def _close_logs(got, want, steps):
    by_step = {m["step"]: m for m in want}
    assert [m["step"] for m in got] == list(steps)
    for m in got:
        for key in ("loss", "grad_norm"):
            assert m[key] == pytest.approx(by_step[m["step"]][key],
                                           rel=TRAJ_RTOL), (m["step"], key)


def test_trajectory_follows_reference():
    ref = _run_ref(TRAJ, 12)
    tr = _trainer(TrainConfig(**TRAJ, optimizer=AdamWConfig(lr=1e-3)))
    tr.train(12)
    _close_logs(tr.metrics_log, ref.metrics_log, range(12))
    assert tr.metrics_log[-1]["loss"] < tr.metrics_log[0]["loss"]


def test_microbatched_trajectory_follows_reference():
    kw = dict(batch=4, seq=32, total_steps=3, microbatches=2)
    ref = _run_ref(kw, 3)
    tr = _trainer(TrainConfig(**kw, optimizer=AdamWConfig(lr=1e-3)))
    tr.train(3)
    _close_logs(tr.metrics_log, ref.metrics_log, range(3))


def test_reference_checkpoint_resumes_in_port_trainer(tmp_path):
    """The reference trains 6 steps and checkpoints; the port's Trainer
    resumes there (params and AdamW state) and continues the reference's
    uninterrupted 12-step trajectory."""
    _run_ref(TRAJ, 6, ckpt_dir=str(tmp_path))
    assert jckpt.latest_step(str(tmp_path)) == 6
    tr = Trainer(CFG, TrainConfig(**TRAJ, ckpt_dir=str(tmp_path),
                                  optimizer=AdamWConfig(lr=1e-3)),
                 device="cpu")
    assert tr.step == 6 and int(tr.opt_state["step"]) == 6
    tr.train(12)
    _close_logs(tr.metrics_log, _run_ref(TRAJ, 12).metrics_log, range(6, 12))


def test_trainer_raises_under_a_cuda_lowering():
    """Backend "cuda" meets the kernel routes' guard at the first step."""
    tr = _trainer(TrainConfig(batch=2, seq=16, total_steps=1),
                  lowering=LoweringConfig("cuda"))
    with pytest.raises(RuntimeError, match="no gradient"):
        tr.train(1)


def test_trainer_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, TrainConfig())


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    tr = main(["--arch", "llama110m", "--smoke", "--device", "cpu",
               "--steps", "2", "--batch", "2", "--seq", "16",
               "--ckpt-dir", str(tmp_path), "--compress-grads"])
    assert tr.step == 2 and "err" in tr.opt_state
    assert "done: step=2" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2


# ---------------------------------------------------------------------------
# Checkpoint interop, both directions
# ---------------------------------------------------------------------------

def _np_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(4, 5)).astype(np.float32),
            "h": {"bf": rng.normal(size=(3, 7)).astype(ml_dtypes.bfloat16),
                  "i": rng.integers(-9, 9, (6,)).astype(np.int32)},
            "step": np.asarray(11, np.int32)}


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
        return x
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def test_reference_checkpoint_loads_in_port_bit_exact(tmp_path):
    tree = _np_tree()
    jckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    loaded, manifest = ckpt.load(str(tmp_path), verify=True)
    assert manifest["step"] == 3
    flat_want = jckpt._flatten(tree)
    flat_got = ckpt._flatten(loaded)
    assert set(flat_got) == set(flat_want)
    for k, want in flat_want.items():
        got = flat_got[k]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), k
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


def test_port_checkpoint_loads_in_reference_with_digests(tmp_path):
    tree = _np_tree()
    ckpt.save(str(tmp_path / "port"), 3, tree_map(_as_torch, tree))
    jckpt.save(str(tmp_path / "ref"), 3, jax.tree.map(jnp.asarray, tree))
    loaded, manifest = jckpt.load(str(tmp_path / "port"), verify=True)
    flat = jckpt._flatten(loaded)
    for k, want in jckpt._flatten(tree).items():
        assert flat[k].dtype == want.dtype, k
        np.testing.assert_array_equal(_bits(flat[k]), _bits(want), err_msg=k)
    # the same files, byte for byte, as the reference writes
    port_dir, ref_dir = tmp_path / "port" / "ckpt_3", tmp_path / "ref" / "ckpt_3"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    for name in os.listdir(ref_dir):
        if name.endswith(".npy"):
            assert (port_dir / name).read_bytes() == \
                (ref_dir / name).read_bytes(), name
    assert json.loads((port_dir / "manifest.json").read_text()) == \
        json.loads((ref_dir / "manifest.json").read_text())


def test_port_trainer_checkpoint_resumes_in_reference(tmp_path):
    """The port's Trainer checkpoint (params + AdamW state, fp32 and the
    int32 step) restores in the reference's Trainer, at the same step and
    bit-equal weights."""
    tr = _trainer(TrainConfig(**TRAJ, ckpt_dir=str(tmp_path),
                              optimizer=AdamWConfig(lr=1e-3)))
    tr.train(6)
    jtr = JaxTrainer(JCFG, JaxTrainConfig(
        **TRAJ, ckpt_dir=str(tmp_path), optimizer=jadamw.AdamWConfig(lr=1e-3)))
    assert jtr.step == 6 and int(jtr.opt_state["step"]) == 6
    np.testing.assert_array_equal(
        np.asarray(jtr.params["embed"]["table"]),
        tr.params["embed"]["table"].numpy())


# ---------------------------------------------------------------------------
# The examples with jax and repro unimportable
# ---------------------------------------------------------------------------

def test_examples_train_then_serve_without_jax(tmp_path):
    (tmp_path / "jax.py").write_text("raise ImportError('no jax here')\n")
    (tmp_path / "repro.py").write_text("raise ImportError('no repro here')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    ck = str(tmp_path / "ck")

    def run(script, *args):
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / script),
             "--smoke", "--device", "cpu", "--ckpt-dir", ck, *args],
            env=env, cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout

    assert "to step 3" in run("train_llm.py", "--steps", "3")
    out = run("serve_llm.py", "--tokens", "4")
    assert f"restored step-3 weights from {ck}" in out
    assert "[cont ]" in out
