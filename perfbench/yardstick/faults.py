"""Faults a serving cell's timed path can have, each planted by wrapping a
function of the program: a step that returns its state unchanged, a
token altered where it is produced, half a batch left out.  A run with
one planted has to read ``correct`` false.  Nothing the benchmark's runs
import uses this module: the CPU tests plant the faults at a tiny size,
and ``control.py --fault`` at a cell's own size on the card.
"""

from __future__ import annotations

import functools

import torch


def unchanged_kv(fn):
    """The paged decode writes its K/V into copies: the cache it returns
    is the one it was given."""
    @functools.wraps(fn)
    def broken(params, x, cfg, k_pages, v_pages, *rest, **kw):
        out, _, _ = fn(params, x, cfg, k_pages.clone(), v_pages.clone(),
                       *rest, **kw)
        return out, k_pages, v_pages
    return broken


def unchanged_pool(fn):
    """The prefill's scatter into the pages does nothing: the prompt's K/V
    never reaches the pool."""
    @functools.wraps(fn)
    def broken(self, slot, kv, length):
        self.seq_lens[slot] = length
    return broken


def unchanged_state(fn):
    """The SSM decode step leaves its conv and state as they were."""
    @functools.wraps(fn)
    def broken(params, u, cfg, cache, lowering=None):
        out, _ = fn(params, u, cfg, {k: v.clone() for k, v in cache.items()},
                    lowering)
        return out, cache
    return broken


def altered_token(fn):
    """The logits a token is chosen from are rolled by one id."""
    @functools.wraps(fn)
    def broken(*args, **kw):
        logits, *rest = fn(*args, **kw)
        return (logits.roll(1, dims=-1), *rest)
    return broken


def half_batch(fn):
    """The prefill computes the first half of the batch and hands its
    results to the rest."""
    @functools.wraps(fn)
    def broken(params, batch, cfg, *args, **kw):
        B = batch["tokens"].shape[0]
        half = {k: v[:B // 2] for k, v in batch.items()}
        logits, caches = fn(params, half, cfg, *args, **kw)
        rep = lambda t, d: torch.cat([t, t], dim=d)  # noqa: E731
        return rep(logits, 0), {k: rep(v, 1) for k, v in caches.items()}
    return broken


def sites():
    """Each fault's name → where it is planted: (owner, attribute,
    wrapper).  Imports the program."""
    from repro_torch.models import layers, mamba2, transformer
    from repro_torch.serve.kv_cache import PagedKVCache
    return {
        "unchanged_kv": (layers, "attention_decode_paged", unchanged_kv),
        "unchanged_pool": (PagedKVCache, "write_prefill", unchanged_pool),
        "altered_token": (transformer, "decode_step_paged", altered_token),
        "unchanged_state": (mamba2, "ssm_block_decode", unchanged_state),
        "altered_token_ssm": (mamba2, "decode_step", altered_token),
        "half_batch": (mamba2, "prefill", half_batch),
    }


#: The faults each cell can have
CELL_FAULTS = {
    "granite8b-chat": ["unchanged_kv", "unchanged_pool", "altered_token"],
    "granite8b-rag": ["unchanged_kv", "unchanged_pool", "altered_token"],
    "mamba2-longdoc": ["unchanged_state", "altered_token_ssm", "half_batch"],
}


def plant(name: str, setattr_=setattr) -> None:
    """Plant the fault ``name`` (``setattr_``: how to set the attribute,
    e.g. a test's ``monkeypatch.setattr``)."""
    owner, attr, wrap = sites()[name]
    setattr_(owner, attr, wrap(getattr(owner, attr)))
