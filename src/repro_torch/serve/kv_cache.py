"""Block-paged KV cache for continuous-batching serving (vLLM-style).

KV lives in a shared pool of fixed-size pages on the device:

    k_pages / v_pages : (L, n_pages, page_size, K, hd)

and each batch *slot* owns a row of a page table mapping logical page p →
physical page id.  The decode step gathers pages through the table, so the
pool, table and length shapes stay fixed no matter which requests come and
go — only the table/length *contents* change.

``PageAllocator`` is host-side bookkeeping (free list with double-free and
leak detection); ``PagedKVCache`` owns the device pools plus the table.

Invariants:

* **Page ownership** — every physical page is either on the allocator's
  free list or owned by exactly one slot (``_slot_pages``).  ``bind_slot``
  reserves a request's whole lifetime up front (prompt bucket + max new
  tokens), so decode can never fail mid-flight; ``release_slot`` is the
  only way pages return to the pool.
* **Free-list discipline** — ``free`` rejects double-frees and foreign
  pages; ``check_leaks`` asserts the pool is exactly full once no request
  is live (the continuous engine calls it after every workload).
* **Snapshot before transfer** — ``device_views`` copies the host-side
  ``page_table``/``seq_lens`` *before* handing them to the device: a
  ``non_blocking`` host→device copy may still be reading the source when
  the engine advances ``seq_lens`` right after dispatching a decode step,
  and on the CPU the tensor would alias the host array outright.  Keep the
  ``.copy()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class PageAllocationError(RuntimeError):
    """Raised when the pool cannot satisfy an allocation."""


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages.

    Guards the two classic lifetime bugs: freeing a page twice and leaking
    pages when a request retires.  ``check_leaks`` asserts the pool is
    exactly full again once no requests are live.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._allocated: set[int] = set()

    @property
    def n_free(self) -> int:
        """Number of pages currently on the free list."""
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        """True iff ``n`` pages can be allocated without failing."""
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages off the free list (all-or-nothing); raises
        ``PageAllocationError`` when the pool can't cover the request."""
        if n > len(self._free):
            raise PageAllocationError(
                f"requested {n} pages, only {len(self._free)} free "
                f"of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        """Return pages to the free list; raises ``PageAllocationError`` on
        a double-free or a page the allocator never handed out."""
        for p in pages:
            if p not in self._allocated:
                raise PageAllocationError(
                    f"double-free or foreign page: {p}")
            self._allocated.remove(p)
            self._free.append(p)

    def check_invariants(self) -> None:
        """Raise ``PageAllocationError`` unless the free list and the
        allocated set exactly partition the pool."""
        if len(self._free) + len(self._allocated) != self.n_pages:
            raise PageAllocationError(
                f"page leak: {len(self._free)} free + "
                f"{len(self._allocated)} allocated != {self.n_pages}")
        if len(set(self._free)) != len(self._free):
            raise PageAllocationError("duplicate free page")
        if set(self._free) & self._allocated:
            raise PageAllocationError("page simultaneously free and allocated")

    def check_leaks(self) -> None:
        """Raise ``PageAllocationError`` unless the pool is exactly full
        again — call once no request is live."""
        self.check_invariants()
        if self._allocated:
            raise PageAllocationError(
                f"{len(self._allocated)} pages leaked: "
                f"{sorted(self._allocated)[:8]}…")


@dataclasses.dataclass
class PagedKVCache:
    """Device page pools + host page table for ``max_batch`` slots."""

    cfg: ModelConfig
    max_batch: int
    page_size: int
    n_pages: int
    max_len: int
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        cfg = self.cfg
        if self.max_len % self.page_size:
            raise ValueError("max_len must be a page multiple")
        self.pages_per_seq = self.max_len // self.page_size
        # n_pages pages for the allocator, then the spare page that takes
        # the decode writes of inactive slots (layers.attention_decode_paged)
        shape = (cfg.n_layers, self.n_pages + 1, self.page_size,
                 cfg.n_kv_heads, cfg.resolved_head_dim())
        cd = L.dtype_of(cfg.compute_dtype)
        self.k_pages = torch.zeros(shape, dtype=cd, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=cd, device=self.device)
        self.allocator = PageAllocator(self.n_pages)
        # Host-side view; pushed to the device when batch membership changes.
        self.page_table = np.zeros((self.max_batch, self.pages_per_seq),
                                   np.int32)
        self.seq_lens = np.zeros((self.max_batch,), np.int32)
        self._slot_pages: dict[int, list[int]] = {}

    # -- lifetime ----------------------------------------------------------

    def pages_needed(self, total_tokens: int) -> int:
        """Pages required to hold ``total_tokens`` KV entries (ceil)."""
        return -(-total_tokens // self.page_size)

    def can_admit(self, total_tokens: int) -> bool:
        """True iff the pool can reserve a whole request lifetime now."""
        return self.allocator.can_alloc(self.pages_needed(total_tokens))

    def bind_slot(self, slot: int, total_tokens: int) -> list[int]:
        """Reserve pages covering the request's whole lifetime (prompt bucket
        + max new tokens) so decode can never fail mid-flight."""
        if slot in self._slot_pages:
            raise PageAllocationError(f"slot {slot} already bound")
        pages = self.allocator.alloc(self.pages_needed(total_tokens))
        self._slot_pages[slot] = pages
        self.page_table[slot] = 0
        self.page_table[slot, :len(pages)] = pages
        self.seq_lens[slot] = 0
        return pages

    def release_slot(self, slot: int) -> None:
        """Free a retired slot's pages and clear its table row — the only
        path by which pages return to the pool."""
        self.allocator.free(self._slot_pages.pop(slot))
        self.page_table[slot] = 0
        self.seq_lens[slot] = 0

    # -- data movement -----------------------------------------------------

    def write_prefill(self, slot: int, kv: dict, length: int) -> None:
        """Scatter a prefill KV stack (L, 1, S_pad, K, hd) into this slot's
        pages.  S_pad must be a page multiple (prompt bucketing guarantees
        it); padded positions are written too but stay masked until decode
        overwrites them."""
        k, v = kv["k"], kv["v"]
        s_pad = k.shape[2]
        if s_pad % self.page_size:
            raise ValueError(f"prefill length {s_pad} is not a page multiple")
        n = s_pad // self.page_size
        ids = torch.as_tensor(self.page_table[slot, :n].astype(np.int64),
                              device=self.device)
        shape = (k.shape[0], n, self.page_size) + tuple(k.shape[3:])
        self.k_pages[:, ids] = k[:, 0].reshape(shape).to(self.k_pages.dtype)
        self.v_pages[:, ids] = v[:, 0].reshape(shape).to(self.v_pages.dtype)
        self.seq_lens[slot] = length

    def device_views(self, active_slots: set[int]):
        """(page_table, seq_lens, active) tensors on the device for the
        decode step.

        The host arrays are snapshotted (``.copy()``) before the transfer:
        the engine advances ``seq_lens`` right after dispatching the decode
        step, and the copy may still be in flight (or, on the CPU, the
        tensor would share the array's memory).
        """
        active = np.zeros((self.max_batch,), bool)
        for s in active_slots:
            active[s] = True
        return tuple(torch.from_numpy(a.copy()).to(self.device,
                                                   non_blocking=True)
                     for a in (self.page_table, self.seq_lens, active))
