"""Deterministic, restart-safe token pipeline (the port of
``repro/data/pipeline.py``, its own numpy copy).

Batches are pure functions of (seed, step): after a failure and a restore
at step k the pipeline produces exactly batch k + 1, and the same
(seed, step) gives the same bits as the reference's pipeline, so a run can
move between the two packages.

Sources: ``"synthetic"`` (a seeded zipf-flavoured token stream) or
``"file"``, a binary file of uint16 tokens (memory-mapped, windows at
random starts each step).  Host-side numpy; the trainer moves batches to
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 0
    source: str = "synthetic"          # 'synthetic' | 'file'
    path: Optional[str] = None
    ignore_id: int = -1


class TokenPipeline:
    def __init__(self, model_cfg: ModelConfig, batch: int, seq: int,
                 cfg: PipelineConfig = PipelineConfig()):
        self.model_cfg = model_cfg
        self.batch = batch
        self.seq = seq
        self.cfg = cfg
        self._file_tokens = None
        if cfg.source == "file":
            if not cfg.path:
                raise ValueError("the file source needs a path")
            self._file_tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def get_batch(self, step: int) -> dict:
        """{'tokens': (B, S) int32, 'labels': (B, S) int32 (the tokens
        shifted by one) [, 'prefix_embeds': (B, P, d) float32]}.  vlm's
        token stream is shortened to S - P, so that prefix and text fill
        S; encdec's prefix is the encoder's frames."""
        rng = self._rng(step)
        B, S, V = self.batch, self.seq, self.model_cfg.vocab
        if self._file_tokens is not None:
            n = len(self._file_tokens) - (S + 1)
            starts = rng.integers(0, max(n, 1), size=B)
            seqs = np.stack([self._file_tokens[s:s + S + 1] for s in starts])
            seqs = seqs.astype(np.int64) % V
        else:
            # zipf-flavoured synthetic stream (heavier head, long tail)
            seqs = rng.zipf(1.3, size=(B, S + 1)) % V
        tokens = seqs[:, :-1].astype(np.int32)
        labels = seqs[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        cfg = self.model_cfg
        if cfg.family in ("vlm", "encdec") and cfg.n_prefix_tokens:
            P = cfg.n_prefix_tokens
            out["prefix_embeds"] = rng.normal(
                size=(B, P, cfg.d_model)).astype(np.float32) * 0.02
            if cfg.family == "vlm":
                out["tokens"] = tokens[:, :max(S - P, 1)]
                out["labels"] = labels[:, :max(S - P, 1)]
        return out
