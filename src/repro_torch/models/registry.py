"""Uniform model API over the ported families: ``get_model(cfg, lowering)``.

The dense and SSM families are ported; every other family raises
``NotImplementedError`` naming the ROADMAP item that brings it.  Only the
attention families have the paged entry points (``prefill_at``,
``decode_paged``); elsewhere they are None, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer

#: Family → the ROADMAP.md item ("Modules still to port") that ports it.
_PENDING = {
    "moe": "item 11 (models/moe.py)",
    "vlm": "item 11 (the vlm prefix mask in transformer.py)",
    "hybrid": "item 11 (models/hybrid.py)",
    "encdec": "item 11 (models/encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable             # (seed, device) -> params
    prefill: Callable          # (params, batch, pad_to) -> (logits, caches)
    decode_step: Callable      # (params, token, caches, pos) -> (logits, caches)
    # Paged-KV serving entry points (continuous batching); only attention
    # families implement them — None elsewhere.
    prefill_at: Optional[Callable] = None   # (params, batch, length)
    #                                         -> (logits, caches)
    decode_paged: Optional[Callable] = None  # (params, tokens, k_pages,
    #                            v_pages, page_table, seq_lens, active)
    #                          -> (logits, k_pages, v_pages)


def get_model(cfg: ModelConfig,
              lowering: Optional[LoweringConfig] = None) -> Model:
    """Bind the family module to a config and a lowering policy (default:
    the ``"cuda"`` backend)."""
    lw = lowering or LoweringConfig()
    if cfg.family == "ssm":
        M = mamba2
        return Model(
            cfg=cfg,
            init=lambda seed=0, device="cpu": M.init_params(cfg, seed, device),
            prefill=lambda p, b, pad_to=None: M.prefill(p, b, cfg,
                                                        pad_to=pad_to,
                                                        lowering=lw),
            decode_step=lambda p, t, c, pos: M.decode_step(p, t, c, pos, cfg,
                                                           lowering=lw),
        )
    if cfg.family != "dense":
        where = _PENDING.get(cfg.family)
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet"
            + (f"; ROADMAP.md {where} brings it" if where else ""))
    T = transformer
    return Model(
        cfg=cfg,
        init=lambda seed=0, device="cpu": T.init_params(cfg, seed, device),
        prefill=lambda p, b, pad_to=None: T.prefill(p, b, cfg, pad_to=pad_to,
                                                    lowering=lw),
        decode_step=lambda p, t, c, pos: T.decode_step(p, t, c, pos, cfg,
                                                       lowering=lw),
        prefill_at=lambda p, b, length: T.prefill_at(p, b, length, cfg,
                                                     lowering=lw),
        decode_paged=lambda p, t, kp, vp, pt, sl, act: T.decode_step_paged(
            p, t, kp, vp, pt, sl, act, cfg, lowering=lw),
    )
