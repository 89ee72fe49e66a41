"""Uniform model API over every family: ``get_model(cfg, lowering)``.

dense, moe and vlm bind ``transformer``, ssm ``mamba2``, hybrid ``hybrid``
and encdec ``encdec``, as in the reference.  Only dense and moe have the
paged entry points (``prefill_at``, ``decode_paged``) that the
continuous-batching engine needs; elsewhere they are None, as in the
reference.  ``param_axes`` gives the logical axes of the param tree that
``sharding/policies.py`` maps onto a mesh.

The dry run's stand-ins for the reference's ``ShapeDtypeStruct``s
(``batch_specs``, ``cache_specs``, ``input_specs``, ``param_specs``) are
tensors on the ``meta`` device: shapes and dtypes, no storage.

Params may be DTensors: then every entry point runs under
``implicit_replication``, so the plain tensors the model makes (masks,
positions, RoPE tables, buffers) count as replicated; with plain params
the entry points are the family functions as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import contextlib

import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, mamba2, transformer
from repro_torch.models import layers as L

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable             # (seed, device) -> params
    loss: Callable             # (params, batch) -> scalar
    prefill: Callable          # (params, batch, pad_to) -> (logits, caches)
    decode_step: Callable      # (params, token, caches, pos) -> (logits, caches)
    # Paged-KV serving entry points (continuous batching); only the dense
    # and moe families implement them — None elsewhere.
    prefill_at: Optional[Callable] = None   # (params, batch, length)
    #                                         -> (logits, caches)
    decode_paged: Optional[Callable] = None  # (params, tokens, k_pages,
    #                            v_pages, page_table, seq_lens, active)
    #                          -> (logits, k_pages, v_pages)
    param_axes: Optional[Callable] = None   # () -> logical axes tree


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree


_REPLICATING = [0]


@contextlib.contextmanager
def replicating(params):
    """``torch.distributed.tensor.experimental.implicit_replication`` when
    ``params`` are DTensors, entered by the outermost call only (the
    library's turns the flag off on leaving, also when an outer one is
    still open): the plain tensors a model makes count as replicated.  A
    backward pass through a model of DTensors (the remat recompute) runs
    under it too.  Plain params: a null context."""
    if _REPLICATING[0] or not L.is_dtensor(_first_leaf(params)):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATING[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING[0] -= 1


def _replicating(fn):
    """``fn(params, ...)`` under ``replicating(params)``."""

    def call(params, *args, **kw):
        with replicating(params):
            return fn(params, *args, **kw)

    return call


def get_model(cfg: ModelConfig,
              lowering: Optional[LoweringConfig] = None) -> Model:
    """Bind the family module to a config and a lowering policy (default:
    the ``"cuda"`` backend, whose kernels have no gradient: ``loss``
    under autograd wants ``LoweringConfig("torch")``, as the trainer
    binds)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)
    mod = _FAMILIES[cfg.family]
    lw = lowering or LoweringConfig()
    paged = {}
    if cfg.family in ("dense", "moe"):
        T = transformer
        paged = {
            "prefill_at": _replicating(lambda p, b, length: T.prefill_at(
                p, b, length, cfg, lowering=lw)),
            "decode_paged": _replicating(
                lambda p, t, kp, vp, pt, sl, act: T.decode_step_paged(
                    p, t, kp, vp, pt, sl, act, cfg, lowering=lw)),
        }
    return Model(
        cfg=cfg,
        init=lambda seed=0, device="cpu": mod.init_params(cfg, seed, device),
        loss=_replicating(lambda p, b: mod.loss(p, b, cfg, lowering=lw)),
        prefill=_replicating(lambda p, b, pad_to=None: mod.prefill(
            p, b, cfg, pad_to=pad_to, lowering=lw)),
        decode_step=_replicating(lambda p, t, c, pos: mod.decode_step(
            p, t, c, pos, cfg, lowering=lw)),
        param_axes=lambda: mod.param_axes(cfg),
        **paged,
    )


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                with_labels: bool) -> dict:
    """Specs for a train/prefill batch of this shape cell."""
    B, S = shape.global_batch, shape.seq_len
    cd = L.dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.family == "vlm":
        P = cfg.n_prefix_tokens
        out["prefix_embeds"] = _sds((B, P, cfg.d_model), cd)
        S = S - P
    elif cfg.family == "encdec":
        out["prefix_embeds"] = _sds((B, cfg.n_prefix_tokens, cfg.d_model), cd)
    out["tokens"] = _sds((B, S), torch.int32)
    if with_labels:
        out["labels"] = _sds((B, S), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, batch: int, T: int) -> dict:
    """Decode-time cache specs (the serve step's state for one new
    token)."""
    cd = L.dtype_of(cfg.compute_dtype)
    Lk = cfg.n_layers
    hd = cfg.resolved_head_dim() if cfg.n_heads else 0
    K = cfg.n_kv_heads
    kv = {"k": _sds((Lk, batch, T, K, hd), cd),
          "v": _sds((Lk, batch, T, K, hd), cd)}
    if cfg.family in ("dense", "moe", "vlm"):
        return kv
    if cfg.family == "encdec":
        return {**kv, "enc_out": _sds((batch, cfg.n_prefix_tokens,
                                       cfg.d_model), cd)}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(cfg.family)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    ssm = {"conv": _sds((Lk, batch, s.conv_width - 1, d_in + 2 * s.d_state),
                        cd),
           "state": _sds((Lk, batch, H, s.d_state, s.head_dim),
                         torch.float32)}
    if cfg.family == "ssm":
        return ssm
    sites = hybrid.n_sites(cfg)
    return {"k": _sds((sites, batch, T, K, hd), cd),
            "v": _sds((sites, batch, T, K, hd), cd), "ssm": ssm}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """All inputs of the shape cell's step function.

    train  → {'batch': …}                              (for train_step)
    prefill→ {'batch': …}                              (for prefill)
    decode → {'token', 'caches', 'pos'}                (for serve_step)
    """
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        B = shape.global_batch
        return {"token": _sds((B,), torch.int32),
                "caches": cache_specs(cfg, B, shape.seq_len),
                "pos": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def param_specs(cfg: ModelConfig) -> dict:
    """The param tree on the ``meta`` device (no allocation)."""
    return get_model(cfg).init(0, "meta")
