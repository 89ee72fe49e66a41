"""Trainer: the train step (loss → gradients → AdamW), gradient
accumulation, checkpointing with auto-resume and straggler monitoring; the
port of ``repro/train/trainer.py``.

The model is bound to ``LoweringConfig("torch")`` unless the caller passes
a lowering: the counterpart of the reference trainer's ``xla`` default.
The hand-written kernels have no gradient (nor have the reference's Pallas
kernels), and their routes raise under autograd
(``kernels.ops.no_grad_guard``), so a ``"cuda"`` lowering fails at the
first step.  fp32 GEMMs stay fp32: the trainer turns on no TF32 (PyTorch's
default leaves it off for matmuls).

Runs on the card unless the caller asks for the CPU (``device="cpu"``);
with no CUDA device and no ``device`` it raises, as the engines do.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.registry import Model, get_model, replicating
from repro_torch.optim import schedule as schedules
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import FailureInjector, StragglerMonitor
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq: int = 128
    microbatches: int = 1          # gradient accumulation factor
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    async_ckpt: bool = False       # overlap checkpoint I/O with training
    log_every: int = 10
    seed: int = 0
    warmup: int = 20
    total_steps: int = 1000
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_and_grads(model: Model, params, batch):
    """(loss, gradients in each leaf's dtype) of ``model.loss`` at
    ``params``; a leaf the loss does not reach gets zeros, as under
    ``jax.grad``.  DTensor params give DTensor gradients, the backward
    pass under ``replicating`` as the forward is."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with replicating(params):
        loss = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(live, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), params and optimizer state updated in place.

    With microbatches > 1 the batch's leading dim is (n_micro, micro_bsz,
    ...): the microbatches run one after another and their gradients add
    up in fp32, as in the reference's scan."""

    def train_step(params, opt_state, batch):
        n = train_cfg.microbatches
        if n > 1:
            loss_sum, g_sum = None, None
            for i in range(n):
                loss, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in batch.items()})
                loss_sum = loss if loss_sum is None else loss_sum + loss
                g_sum = (tree_map(lambda x: x.float(), g) if g_sum is None
                         else tree_map(torch.add, g_sum, g))
            loss = loss_sum / n
            grads = tree_map(lambda x: x / n, g_sum)
        else:
            loss, grads = loss_and_grads(model, params, batch)
        lr_scale = schedules.warmup_cosine(
            opt_state["step"], warmup=train_cfg.warmup,
            total=train_cfg.total_steps)
        params, opt_state, m = apply_updates(params, grads, opt_state,
                                             opt_cfg, lr_scale)
        m["loss"] = loss
        return params, opt_state, m

    return train_step


def _cast_like(ref, x):
    return x.to(device=ref.device, dtype=ref.dtype)


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 pipeline_cfg: PipelineConfig = PipelineConfig(),
                 failure_injector: Optional[FailureInjector] = None, *,
                 params=None, lowering: Optional[LoweringConfig] = None,
                 device=None):
        """``params`` (a port tree, e.g. ``bridge.params_from_numpy`` of
        the reference's init) replaces the family's own
        ``init_params(cfg, seed, device)``; a checkpoint in
        ``train_cfg.ckpt_dir`` replaces both."""
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.model = get_model(model_cfg,
                               lowering=lowering or LoweringConfig("torch"))
        self.pipeline = TokenPipeline(model_cfg, train_cfg.batch,
                                      train_cfg.seq, pipeline_cfg)
        self.monitor = StragglerMonitor()
        self.injector = failure_injector
        self.step = 0
        self.metrics_log: list[dict] = []

        if params is None:
            params = self.model.init(train_cfg.seed, self.device)
        else:
            params = tree_map(lambda p: p.detach().to(self.device).clone(),
                              params)
        opt_state = init_state(params, train_cfg.optimizer)
        # auto-resume from the newest valid checkpoint
        if (train_cfg.ckpt_dir
                and ckpt.latest_step(train_cfg.ckpt_dir) is not None):
            tree, manifest = ckpt.load(train_cfg.ckpt_dir, device=self.device)
            params = tree_map(_cast_like, params, tree["params"])
            opt_state = tree_map(_cast_like, opt_state, tree["opt_state"])
            self.step = manifest["step"]
        self.params = params
        self.opt_state = opt_state
        self._step_fn = make_train_step(self.model, train_cfg.optimizer,
                                        train_cfg)
        self._ckpt_thread = None

    def _device_batch(self, step: int) -> dict:
        b = self.pipeline.get_batch(step)
        if self.cfg.microbatches > 1:
            n = self.cfg.microbatches
            b = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                 for k, v in b.items()}
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def train(self, total_steps: int) -> dict:
        last = {}
        while self.step < total_steps:
            t0 = time.perf_counter()
            step = self.step
            if self.injector:
                self.injector.maybe_fail(step)
            batch = self._device_batch(step)
            self.params, self.opt_state, m = self._step_fn(
                self.params, self.opt_state, batch)
            m = {k: float(v) for k, v in m.items()}
            self.step = step + 1
            dt = time.perf_counter() - t0
            ev = self.monitor.record(step, dt)
            m["step_time"] = dt
            if ev is not None:
                m["straggler_z"] = ev.z
            self.metrics_log.append({"step": step, **m})
            last = m
            if (self.cfg.ckpt_dir
                    and self.step % self.cfg.ckpt_every == 0):
                self.save_checkpoint()
        if self.cfg.ckpt_dir:
            self.save_checkpoint()
            self.wait_for_checkpoint()
        return last

    def save_checkpoint(self) -> None:
        """Checkpoint the current state.  With ``async_ckpt`` the
        device→host snapshot (``.cpu()`` copies) is taken synchronously,
        before the writer thread starts, and the file write overlaps the
        next steps, which update the live tensors in place; the previous
        write is joined first, so at most one is in flight."""
        tree = {"params": self.params, "opt_state": self.opt_state}
        extra = {"model": self.model_cfg.name}
        step = self.step
        if not self.cfg.async_ckpt:
            ckpt.save(self.cfg.ckpt_dir, step, tree, extra=extra)
            ckpt.gc(self.cfg.ckpt_dir, keep=self.cfg.keep_ckpts)
            return
        self.wait_for_checkpoint()
        snapshot = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        def write():
            ckpt.save(self.cfg.ckpt_dir, step, snapshot, extra=extra)
            ckpt.gc(self.cfg.ckpt_dir, keep=self.cfg.keep_ckpts)

        self._ckpt_thread = threading.Thread(target=write, daemon=True)
        self._ckpt_thread.start()

    def wait_for_checkpoint(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
