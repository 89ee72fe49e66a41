"""Request queue + continuous-batching scheduler (a copy of the reference's
``serve/scheduler.py``: pure Python and numpy, same RNG, so one seed gives
one workload on both sides).

The scheduler owns the mapping *batch slot → request*.  Each engine step it
(1) retires slots whose request hit its token budget, freeing their pages,
and (2) admits queued requests into free slots whenever the page pool can
cover the request's whole lifetime — so a late-arriving short request rides
along with in-flight long ones instead of waiting for the batch to drain
(the decode batch shape never changes; see ``kv_cache.PagedKVCache``).

Arrival times are expressed in *decode steps* (virtual time): request i is
eligible once the engine has executed ``arrival_step`` steps.  That keeps
workloads deterministic across hosts of very different speeds while latency
metrics (TTFT/ITL) are still measured in wall-clock seconds.

Invariants:

* Every in-flight request is bound to exactly one slot, and every slot id
  is either in ``Scheduler.slots`` or on the free list — never both.
  ``bind`` is only legal when ``has_capacity()``; ``retire`` is the only
  way a slot returns to the free list.
* Admission is FIFO past the queue head only (``pop_eligible``): a request
  can never be overtaken, so no request starves behind the head-of-line
  page wait.
* The scheduler never touches KV pages itself — page ownership lives in
  ``kv_cache.PagedKVCache``; the engine must bind/release cache pages in
  lock-step with ``bind``/``retire`` (see ``engine.ContinuousEngine``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request: prompt, token budget, and latency stamps
    (``t_*`` fields are filled in by the serving engine)."""

    rid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int
    arrival_step: int = 0
    # Filled in by the engine:
    out_tokens: list = dataclasses.field(default_factory=list)
    t_eligible: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        """Number of prompt tokens."""
        return int(self.prompt.shape[0])

    @property
    def ttft_s(self) -> float:
        """Time to first token: eligibility → first generated token."""
        return self.t_first_token - self.t_eligible

    @property
    def itl_s(self) -> float:
        """Mean inter-token latency over the generated tokens."""
        n = len(self.out_tokens)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


class RequestQueue:
    """FIFO of pending requests with virtual-time arrival gating."""

    def __init__(self):
        self._q: collections.deque[Request] = collections.deque()

    def push(self, req: Request) -> None:
        """Append a request to the tail of the queue."""
        self._q.append(req)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)

    def head(self) -> Optional[Request]:
        """The next request to be admitted (None when empty)."""
        return self._q[0] if self._q else None

    def pop_eligible(self, step: int) -> Optional[Request]:
        """Pop the head iff it has arrived by ``step`` (FIFO — no reordering
        past the head, so no request starves)."""
        if self._q and self._q[0].arrival_step <= step:
            return self._q.popleft()
        return None

    def head_arrival(self) -> Optional[int]:
        """Arrival step of the queue head (None when empty)."""
        return self._q[0].arrival_step if self._q else None


class Scheduler:
    """Slot manager for continuous batching over ``max_batch`` slots."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.slots: dict[int, Request] = {}      # slot -> in-flight request
        self._free_slots = list(range(max_batch - 1, -1, -1))

    @property
    def active_slots(self) -> set[int]:
        """Slot ids currently bound to in-flight requests."""
        return set(self.slots)

    def has_capacity(self) -> bool:
        """True iff at least one decode slot is free."""
        return bool(self._free_slots)

    def has_active(self) -> bool:
        """True iff any request is still in flight."""
        return bool(self.slots)

    def bind(self, req: Request) -> int:
        """Bind a request to a free slot; returns the slot id.  Only legal
        when ``has_capacity()`` — the engine checks before admitting."""
        slot = self._free_slots.pop()
        self.slots[slot] = req
        return slot

    def finished_slots(self) -> list[int]:
        """Slots whose request has produced its full token budget."""
        return [s for s, r in self.slots.items()
                if len(r.out_tokens) >= r.max_new_tokens]

    def retire(self, slot: int) -> Request:
        """Unbind a slot and return it to the free list; the caller must
        release the slot's KV pages in the same scheduler iteration."""
        req = self.slots.pop(slot)
        self._free_slots.append(slot)
        return req


def pick_bucket(prompt_len: int, buckets: tuple[int, ...]) -> int:
    """Smallest prefill bucket covering the prompt (bounds the prefill
    shapes to ``len(buckets)`` variants)."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                     f"prefill bucket {buckets[-1]}")


def make_poisson_workload(n_requests: int, *, rate: float, vocab: int,
                          prompt_lens: tuple[int, ...] = (8, 16, 24, 32),
                          out_lens: tuple[int, ...] = (4, 8, 16, 48),
                          seed: int = 0) -> list[Request]:
    """Mixed-length workload with Poisson arrivals in step-space: inter-
    arrival gaps ~ Exp(rate) decode steps, prompt/output lengths sampled
    uniformly from the given grids.  Deterministic under ``seed`` so the
    static and continuous engines see the identical request stream."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab, rng.choice(prompt_lens),
                                dtype=np.int32),
            max_new_tokens=int(rng.choice(out_lens)),
            arrival_step=int(t),
        ))
    return reqs
