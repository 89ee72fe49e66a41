"""Serving engines: the static-batch ``ServeEngine`` (one prefill + a greedy
decode loop over the model's caches — a monolithic KV cache, or the SSM
family's conv and state — TTFT/ITL, the paper's §6.5 LLM inference
metrics), the continuous-batching ``ContinuousEngine`` (attention
families only: it refuses a model without a paged decode path) and
``StaticBatchEngine``, classic static batching over the same workload API
(the baseline the continuous engine is compared against):

    RequestQueue → Scheduler (slot admission/retirement)
                 → PagedKVCache (fixed-size pages, free-list allocator)
                 → fixed-shape decode step (gathers pages via the page table)

New requests join in-flight decode batches the moment a slot and enough
pages free up; prompts are prefilled one at a time into bucketed shapes
and their KV scattered into pages.

All engines run on the card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no ``device`` they raise.  The
kernels come from a ``LoweringConfig`` (default backend ``"cuda"``).  With
``quantize=True`` every ≥2-D weight is quantized to int8 per tensor and
dequantized once, at load (``quantize_params_int8``): the model then runs
on the dequantized weights, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.registry import Model, get_model
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import (Request, RequestQueue, Scheduler,
                                         pick_bucket)
from repro_torch.tree import tree_leaves, tree_map


def quantize_params_int8(params):
    """Per-tensor symmetric int8 quantization of every ≥2-D weight (one scale
    a stacked leaf, ``max(max|p|, 1e-12) / 127`` in fp32; ``p / scale``
    rounded half to even and clipped to ±127); 1-D leaves stay as they are.
    Returns (the tree with {'q', 'scale', 'dtype'} leaves, the dequant
    function: ``q · scale`` in fp32, cast to the leaf's own dtype)."""

    def _quant(p):
        if isinstance(p, dict):
            return {k: _quant(v) for k, v in p.items()}
        if p.dim() < 2:
            return p
        pf = p.float()
        scale = torch.clamp(pf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(pf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale,
                "dtype": str(p.dtype).removeprefix("torch.")}

    def _dequant(tree):
        if isinstance(tree, dict) and "q" in tree:
            return (tree["q"].float() * tree["scale"]).to(
                L.dtype_of(tree["dtype"]))
        if isinstance(tree, dict):
            return {k: _dequant(v) for k, v in tree.items()}
        return tree

    return _quant(params), _dequant


def quantization_error(params, qtree, dequant) -> float:
    """Mean relative L1 error of the int8 round trip over all weights."""
    deq = dequant(qtree)
    num = sum(float(torch.sum(torch.abs(a.float() - b.float())))
              for a, b in zip(tree_leaves(params), tree_leaves(deq)))
    den = sum(float(torch.sum(torch.abs(a))) for a in tree_leaves(params))
    return num / max(den, 1e-12)


def _init_params(model: Model, params, quantize: bool, seed: int,
                 device: torch.device):
    """The caller's params (or the model's own from ``seed``) on ``device``,
    through the int8 round trip when ``quantize``."""
    params = (model.init(seed, device) if params is None
              else tree_map(lambda p: p.to(device), params))
    if quantize:
        qtree, dequant = quantize_params_int8(params)
        params = dequant(qtree)
    return params


@dataclasses.dataclass
class ServeStats:
    """Latency/throughput stats for one static-batch generation."""

    ttft_s: float
    itl_s: float
    tokens: int
    tokens_per_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Single-batch prefill + greedy decode over the model's caches (updated
    in place) — the TTFT/ITL harness and the numerics reference for the
    paged engine."""

    def __init__(self, model_cfg: ModelConfig, params=None, *,
                 max_len: int = 512, quantize: bool = False, seed: int = 0,
                 lowering: Optional[LoweringConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.lowering = lowering if lowering is not None else LoweringConfig()
        self.model = get_model(model_cfg, lowering=self.lowering)
        self.max_len = max_len
        # int8 at rest, dequantized once on load
        self.params = _init_params(self.model, params, quantize, seed,
                                   self.device)

    def generate(self, batch: dict, n_tokens: int
                 ) -> tuple[np.ndarray, ServeStats]:
        """Prefill ``batch`` ({'tokens': (B, S)}, and ``prefix_embeds`` (B,
        P, d) for vlm and encdec) and greedily decode ``n_tokens`` tokens;
        returns ``(tokens (B, n_tokens), ServeStats)``.  A vlm's decode
        starts at S + n_prefix_tokens, past its prefix, as the
        reference's does."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        n_prefix = self.cfg.n_prefix_tokens if self.cfg.family == "vlm" else 0
        pos = batch["tokens"].shape[1] + n_prefix
        with obs.span("serve.generate"):
            with obs.span("serve.prefill") as pre:
                logits, caches = self.model.prefill(self.params, batch,
                                                    self.max_len)
            with obs.span("serve.prefill.wait") as wait:
                _sync(self.device)
            with obs.span("serve.first_token") as first:
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                out = [token.cpu().numpy()]
            last = first
            for i in range(n_tokens - 1):
                with obs.span("serve.decode.enqueue"):
                    logits, caches = self.model.decode_step(
                        self.params, token, caches, pos + i)
                    token = torch.argmax(logits, dim=-1).to(torch.int32)
                with obs.span("serve.decode.fetch") as last:
                    out.append(token.cpu().numpy())
        # TTFT: prefill → its sync; ITL: the first token's fetch → the last
        itl = (last.t1 - first.t1) / max(n_tokens - 1, 1)
        stats = ServeStats(ttft_s=wait.t1 - pre.t0, itl_s=itl,
                           tokens=n_tokens,
                           tokens_per_s=n_tokens / (last.t1 - pre.t0))
        return np.stack(out, axis=1), stats


# ---------------------------------------------------------------------------
# Workload-level serving (lists of Requests with arrival times)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadStats:
    """Aggregate latency/throughput over one served request workload."""

    n_requests: int
    total_tokens: int
    wall_s: float
    tokens_per_s: float
    mean_ttft_s: float
    mean_itl_s: float
    decode_steps: int


def _aggregate(requests: list[Request], wall_s: float,
               decode_steps: int) -> WorkloadStats:
    total = sum(len(r.out_tokens) for r in requests)
    ttfts = [r.ttft_s for r in requests if r.t_first_token is not None]
    itls = [r.itl_s for r in requests if len(r.out_tokens) > 1]
    return WorkloadStats(
        n_requests=len(requests), total_tokens=total, wall_s=wall_s,
        tokens_per_s=total / max(wall_s, 1e-9),
        mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
        mean_itl_s=float(np.mean(itls)) if itls else 0.0,
        decode_steps=decode_steps)


DEFAULT_BUCKETS = (16, 32, 64)


def _filter_buckets(buckets: tuple[int, ...], max_len: int) -> tuple[int, ...]:
    out = tuple(b for b in sorted(buckets) if b <= max_len)
    if not out:
        raise ValueError(f"no prompt bucket in {buckets} fits max_len {max_len}")
    return out


class ContinuousEngine:
    """Continuous-batching server over a paged KV cache.

    ``max_batch`` decode slots share a pool of ``n_pages`` KV pages; the
    decode step's shapes are fixed at construction, so admissions and
    retirements only change the contents of the page table and lengths.
    Arrival times are in decode steps (virtual time, see ``scheduler``);
    latencies are wall-clock.  The KV pools are updated in place.
    """

    def __init__(self, model_cfg: ModelConfig, params=None, *,
                 max_batch: int = 8, page_size: int = 16,
                 max_len: int = 128, n_pages: Optional[int] = None,
                 prompt_buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 quantize: bool = False, seed: int = 0,
                 lowering: Optional[LoweringConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.lowering = lowering if lowering is not None else LoweringConfig()
        self.model = get_model(model_cfg, lowering=self.lowering)
        if self.model.decode_paged is None:
            raise ValueError(
                f"family {model_cfg.family!r} has no paged decode path")
        self.params = _init_params(self.model, params, quantize, seed,
                                   self.device)
        self.max_len = max_len
        self.prompt_buckets = _filter_buckets(prompt_buckets, max_len)
        if any(b % page_size for b in self.prompt_buckets):
            raise ValueError("prompt buckets must be page multiples")
        if n_pages is None:
            n_pages = max_batch * (max_len // page_size)
        self.cache = PagedKVCache(model_cfg, max_batch=max_batch,
                                  page_size=page_size, n_pages=n_pages,
                                  max_len=max_len, device=self.device)
        self.scheduler = Scheduler(max_batch)
        self.queue = RequestQueue()
        self.step_count = 0
        self._next_tokens = np.zeros((max_batch,), np.int32)
        self._prefill = self.model.prefill_at
        # Decode state lives on the device between steps; the host uploads
        # it again only when batch membership changes, and argmax + the
        # length advance run on the device, so a steady decode step is one
        # dispatch plus one small token fetch.
        self._device_state = None
        self._membership_dirty = True

        def _decode_fn(p, t, kp, vp, pt, sl, act):
            logits, kp, vp = self.model.decode_paged(p, t, kp, vp, pt, sl, act)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return nxt, kp, vp, sl + act.to(sl.dtype)

        self._decode = _decode_fn
        self._resolve_lowerings(max_batch)

    # -- internals ---------------------------------------------------------

    def _resolve_lowerings(self, max_batch: int) -> None:
        """Look up the compile records of the decode step's and each
        bucket's prefill attention and norms, and of the unembedding GEMM,
        now, while the engine is built: the first lookup of a trace spec
        runs its e-graph saturation, which would otherwise fall into the
        first request's TTFT (a later key of a saturated spec is a quick
        decision).  The shapes are fixed here (slots, pages, buckets)."""
        cfg = self.cfg
        lw = self.lowering
        dt = L.dtype_of(cfg.compute_dtype)
        d, H, K, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim())
        T = self.cache.pages_per_seq * self.cache.page_size
        lw.lower("rmsnorm", (max_batch, d), dt)
        lw.lower("attention_paged", (max_batch, 1, H, K, T, hd), dt)
        lw.lower("matmul", (max_batch, d, cfg.vocab), dt)
        lw.lower("matmul", (1, d, cfg.vocab), dt)
        for b in self.prompt_buckets:
            lw.lower("rmsnorm", (b, d), dt)
            lw.lower("attention", (1, b, H, K, b, hd), dt)

    def _lifetime_tokens(self, req: Request, bucket: int) -> int:
        return max(bucket, req.prompt_len + req.max_new_tokens)

    def _admit(self, req: Request) -> None:
        with obs.span("serve.admit", rid=req.rid) as adm:
            obs.record("serve.queued", req.t_submit, adm.t0, rid=req.rid)
            slot = self.scheduler.bind(req)
            bucket = pick_bucket(req.prompt_len, self.prompt_buckets)
            self.cache.bind_slot(slot, self._lifetime_tokens(req, bucket))
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :req.prompt_len] = req.prompt
            logits, kv = self._prefill(
                self.params,
                {"tokens": torch.from_numpy(tokens).to(self.device)},
                req.prompt_len)
            self.cache.write_prefill(slot, kv, req.prompt_len)
            # the host waits for the prefill here
            with obs.span("serve.first_token", rid=req.rid) as fetch:
                first = int(torch.argmax(logits[0]))
            req.out_tokens.append(first)
            req.t_first_token = fetch.t1
            if len(req.out_tokens) >= req.max_new_tokens:
                req.t_done = fetch.t1
            self._next_tokens[slot] = first
            self._membership_dirty = True

    def _retire_finished(self) -> None:
        for slot in self.scheduler.finished_slots():
            self.scheduler.retire(slot)
            self.cache.release_slot(slot)
            self._membership_dirty = True

    def step(self) -> bool:
        """One scheduler iteration: retire → admit (+prefill) → decode.
        Returns True iff a decode step actually ran.  Recorded as span
        ``serve.step`` with the lowering lookups it made; the
        decode's token fetch is where the host waits for the device."""
        disp = self.lowering.dispatcher
        lookups0 = disp.hits + disp.misses
        with obs.span("serve.step") as st:
            now = st.t0
            self._retire_finished()
            # Stamp eligibility (for TTFT) on everything that has arrived.
            for r in self.queue:
                if r.arrival_step <= self.step_count and r.t_eligible is None:
                    r.t_eligible = now
            while self.scheduler.has_capacity():
                head = self.queue.head()
                if head is None or head.arrival_step > self.step_count:
                    break
                bucket = pick_bucket(head.prompt_len, self.prompt_buckets)
                if not self.cache.can_admit(
                        self._lifetime_tokens(head, bucket)):
                    break  # FIFO head-of-line: wait for pages to free
                req = self.queue.pop_eligible(self.step_count)
                if req.t_eligible is None:
                    req.t_eligible = now
                self._admit(req)
            # A request whose budget was met at prefill (max_new_tokens ==
            # 1) must not ride through a decode dispatch.
            self._retire_finished()
            active = self.scheduler.active_slots
            if active:
                if self._membership_dirty or self._device_state is None:
                    pt, sl, act = self.cache.device_views(active)
                    # snapshot: _next_tokens is mutated after dispatch and
                    # the host→device copy may still be in flight (see
                    # device_views)
                    tokens_d = torch.from_numpy(self._next_tokens.copy()).to(
                        self.device, non_blocking=True)
                    self._device_state = (tokens_d, pt, sl, act)
                    self._membership_dirty = False
                tokens_d, pt, sl, act = self._device_state
                with obs.span("serve.decode.enqueue"):
                    tokens_d, self.cache.k_pages, self.cache.v_pages, sl = \
                        self._decode(self.params, tokens_d,
                                     self.cache.k_pages, self.cache.v_pages,
                                     pt, sl, act)
                self._device_state = (tokens_d, pt, sl, act)
                with obs.span("serve.decode.fetch") as fetch:
                    nxt = tokens_d.cpu().numpy()
                for slot in active:
                    req = self.scheduler.slots[slot]
                    self.cache.seq_lens[slot] += 1
                    if len(req.out_tokens) < req.max_new_tokens:
                        req.out_tokens.append(int(nxt[slot]))
                        if len(req.out_tokens) >= req.max_new_tokens:
                            req.t_done = fetch.t1
                    self._next_tokens[slot] = nxt[slot]
            self.step_count += 1
            st.attrs["lookups"] = disp.hits + disp.misses - lookups0
        return bool(active)

    # -- public API --------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request, rejecting one that could never be admitted
        (lifetime exceeding ``max_len`` or the whole page pool)."""
        bucket = pick_bucket(req.prompt_len, self.prompt_buckets)
        lifetime = self._lifetime_tokens(req, bucket)
        if lifetime > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens} exceeds max_len {self.max_len}")
        if self.cache.pages_needed(lifetime) > self.cache.n_pages:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self.cache.pages_needed(lifetime)} pages but the pool "
                f"only has {self.cache.n_pages} — it could never be "
                f"admitted")
        req.t_submit = time.perf_counter()
        self.queue.push(req)

    def run(self, requests: list[Request]) -> WorkloadStats:
        """Serve a whole workload to completion; raises if a page leaked."""
        for r in requests:
            self.submit(r)
        # Arrival steps are relative to workload start; a reused engine must
        # not carry a prior run's step count into the gating.
        self.step_count = 0
        t0 = time.perf_counter()
        decode_steps = 0
        while self.queue or self.scheduler.has_active():
            decode_steps += int(self.step())
        wall = time.perf_counter() - t0
        self.cache.allocator.check_leaks()
        return _aggregate(requests, wall, decode_steps)


class StaticBatchEngine:
    """Classic static batching over the workload API: groups of up to
    ``batch`` eligible requests are padded to a common prompt bucket,
    prefilled together, and decoded for max(output length) steps — the
    whole group holds its slots until the longest member finishes.  Output
    tokens of shorter-prompt members are computed at padded positions
    (standard static-batch behaviour); this engine is the throughput and
    latency baseline, the numerics reference is ``ServeEngine``.  The KV
    cache is updated in place."""

    def __init__(self, model_cfg: ModelConfig, params=None, *,
                 batch: int = 8, max_len: int = 128,
                 prompt_buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 quantize: bool = False, seed: int = 0,
                 lowering: Optional[LoweringConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.lowering = lowering if lowering is not None else LoweringConfig()
        self.model = get_model(model_cfg, lowering=self.lowering)
        self.params = _init_params(self.model, params, quantize, seed,
                                   self.device)
        self.batch = batch
        self.max_len = max_len
        self.prompt_buckets = _filter_buckets(prompt_buckets, max_len)
        self._prefill = lambda p, b: self.model.prefill(p, b, self.max_len)

        def _decode_fn(p, t, c, pos):
            logits, c = self.model.decode_step(p, t, c, pos)
            return torch.argmax(logits, dim=-1).to(torch.int32), c

        self._decode = _decode_fn

    def run(self, requests: list[Request]) -> WorkloadStats:
        """Serve a workload in static groups (the baseline scheduler)."""
        queue = RequestQueue()
        for r in requests:
            queue.push(r)
        t0 = time.perf_counter()
        step_count = 0
        decode_steps = 0
        while queue:
            now = time.perf_counter()
            for r in queue:
                if r.arrival_step <= step_count and r.t_eligible is None:
                    r.t_eligible = now
            group = []
            while len(group) < self.batch:
                req = queue.pop_eligible(step_count)
                if req is None:
                    break
                if req.t_eligible is None:
                    req.t_eligible = now
                group.append(req)
            if not group:
                step_count += 1  # idle: wait for the next arrival
                continue
            bucket = pick_bucket(max(r.prompt_len for r in group),
                                 self.prompt_buckets)
            n_gen = max(r.max_new_tokens for r in group)
            # Decode writes KV at positions bucket..bucket+n_gen-2 (the last
            # generated token is never fed back).
            if bucket + n_gen - 1 > self.max_len:
                raise ValueError(
                    f"group needs positions up to {bucket + n_gen - 2} but "
                    f"the KV cache holds max_len={self.max_len}")
            tokens = np.zeros((self.batch, bucket), np.int32)
            for i, r in enumerate(group):
                tokens[i, :r.prompt_len] = r.prompt
            logits, caches = self._prefill(
                self.params, {"tokens": torch.from_numpy(tokens).to(
                    self.device)})
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            host = token.cpu().numpy()  # sync before the TTFT stamp
            now = time.perf_counter()
            for i, r in enumerate(group):
                r.out_tokens.append(int(host[i]))
                r.t_first_token = now
                if r.max_new_tokens == 1:
                    r.t_done = now
            n_steps = n_gen - 1
            for j in range(n_steps):
                token, caches = self._decode(self.params, token, caches,
                                             bucket + j)
                host = token.cpu().numpy()
                now = time.perf_counter()
                for i, r in enumerate(group):
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(host[i]))
                        if len(r.out_tokens) >= r.max_new_tokens:
                            r.t_done = now
                # Requests whose virtual arrival falls inside this group's
                # decode start waiting now; stamping here (not after the
                # group drains) charges that head-of-line wait to their TTFT.
                for r in queue:
                    if (r.arrival_step <= step_count + j + 1
                            and r.t_eligible is None):
                        r.t_eligible = now
            step_count += n_steps
            decode_steps += n_steps
        wall = time.perf_counter() - t0
        return _aggregate(requests, wall, decode_steps)
