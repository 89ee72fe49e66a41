"""Uniform model API over every family: ``get_model(cfg, lowering)``.

dense, moe and vlm bind ``transformer``, ssm ``mamba2``, hybrid ``hybrid``
and encdec ``encdec``, as in the reference.  Only dense and moe have the
paged entry points (``prefill_at``, ``decode_paged``) that the
continuous-batching engine needs; elsewhere they are None, as in the
reference.  The reference's ``ShapeDtypeStruct`` specs of the dry-run
(``batch_specs``, ``cache_specs``, ``input_specs``, ``param_specs``) come
with the distribution slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba2, transformer

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
            "prefill_at": lambda p, b, length: T.prefill_at(
                p, b, length, cfg, lowering=lw),
            "decode_paged": lambda p, t, kp, vp, pt, sl, act:
                T.decode_step_paged(p, t, kp, vp, pt, sl, act, cfg,
                                    lowering=lw),
        }
    return Model(
        cfg=cfg,
        init=lambda seed=0, device="cpu": mod.init_params(cfg, seed, device),
        loss=lambda p, b: mod.loss(p, b, cfg, lowering=lw),
        prefill=lambda p, b, pad_to=None: mod.prefill(p, b, cfg,
                                                      pad_to=pad_to,
                                                      lowering=lw),
        decode_step=lambda p, t, c, pos: mod.decode_step(p, t, c, pos, cfg,
                                                         lowering=lw),
        **paged,
    )
