"""Model configuration dataclasses, the dry run's shape cells and the
smoke-size reduction.

A copy of the reference's ``configs/base.py`` for the fields the port's
families read; ``reduced`` keeps the reference's rule exactly, so a reduced
config names the same shapes on both sides of a parity test, and
``SHAPES``/``applicable_shapes`` name the reference's four cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0   # arctic: parallel dense FFN next to MoE
    # dispatch: 'sort' (argsort + scatter into expert buffers; the fewest
    # FLOPs) or 'grouped' (GShard one-hot einsums over token groups; the
    # reference's shardable form, also at decode)
    dispatch: str = "sort"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2              # d_inner = expand * d_model
    chunk: int = 256             # SSD chunk length (the plain version's)
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k-th layer
    shared_attn_every: int = 0
    # encdec: n_layers encoder + n_layers decoder layers;
    # vlm / encdec: prefix embeddings (image patches / audio frames) given
    # by the caller in place of a frontend
    n_prefix_tokens: int = 0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    remat: str = "dots"
    norm_eps: float = 1e-6

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: ssm and hybrid run ``long_500k``; the
        attention families skip it, as in the reference."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (the reference's formula)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.resolved_head_dim()
        attn = (d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                + hd * self.n_heads * d)
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            ssm_per = (d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim)
                       + d_in * d + d_in * s.conv_width)
            body = L * ssm_per
            if self.family == "hybrid":
                body += attn + 3 * d * ff  # one shared block
        elif self.family == "moe":
            mlp = (3 * d * ff * self.moe.n_experts
                   + 3 * d * self.moe.dense_residual_ff)
            body = L * (attn + mlp + d * self.moe.n_experts)
        elif self.family == "encdec":
            body = L * (attn + 3 * d * ff) + L * (2 * attn + 3 * d * ff)
        else:
            body = L * (attn + 3 * d * ff)
        return body + V * d * (1 if self.tie_embeddings else 2)

    def n_active_params(self) -> int:
        """Parameters a token passes through (MoE: its top-k experts)."""
        if self.family != "moe":
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim()
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + hd * self.n_heads * d)
        mlp = 3 * d * ff * self.moe.top_k + 3 * d * self.moe.dense_residual_ff
        body = L * (attn + mlp + d * self.moe.n_experts)
        return body + self.vocab * self.d_model * 2


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """The cells a config runs: every one but ``long_500k`` for the
    quadratic-attention families."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.supports_long_context]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test configuration of the same family: tiny depth/width/vocab,
    keeping every structural feature (GQA ratio, bias, MoE top-k, SSM
    state, shared-attention period, prefix tokens)."""
    kv_ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    moe = None
    if cfg.moe:
        moe = MoEConfig(n_experts=min(8, cfg.moe.n_experts),
                        top_k=min(cfg.moe.top_k, 2),
                        capacity_factor=cfg.moe.capacity_factor,
                        dense_residual_ff=64 if cfg.moe.dense_residual_ff else 0,
                        dispatch=cfg.moe.dispatch)
    ssm = None
    if cfg.ssm:
        ssm = SSMConfig(d_state=16, head_dim=8, expand=2, chunk=16,
                        conv_width=cfg.ssm.conv_width)
    return dataclasses.replace(
        cfg,
        n_layers=2 if cfg.shared_attn_every == 0 else 4,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=128,
        vocab=512,
        head_dim=16,
        moe=moe,
        ssm=ssm,
        shared_attn_every=min(cfg.shared_attn_every, 2) if cfg.shared_attn_every else 0,
        n_prefix_tokens=min(cfg.n_prefix_tokens, 4),
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
