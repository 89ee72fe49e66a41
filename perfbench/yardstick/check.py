"""What decides ``correct``: served tokens held to the plain fp32
reference.

For a sample of the requests that finished in the window, drawn from the
seed and holding the longest, the reference runs once over each prompt
with its served tokens and gives fp32 logits at every served position.
A served token's gap is how far its reference logit lies below the
reference's best there; ``logit_gap`` is the widest over the sample.  The
control, the reference at fp8 in the program's place, reads at the same
positions the gap of the token that the lower precision puts first.

A paged KV cache is held to the reference besides: at the window's close
the pages of a sample of the requests still decoding are copied to the
host, and ``kv_error`` is the widest relative error (Frobenius norms) of
their K or V in one layer, over the prompt's positions and, apart, over
the decoded tokens' own, against the K and V the reference works out from
the same tokens.  A cache write left out reads about 1 there, however
diffuse the model's attention.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(reqs, k: int, seed: int) -> list:
    """Up to ``k`` finished requests: the longest (prompt + output), then
    others drawn from the seed."""
    done = [r for r in reqs if r.done and not r.failed]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.max_new, -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def sequences(reqs, device):
    """(token sequences, wanted positions, served tokens) for the
    reference: each prompt with its served tokens but the last, the
    logits wanted at the positions that chose each served token."""
    seqs, wanted, served = [], [], []
    for r in reqs:
        toks = np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.tokens[:-1], np.int64)])
        p = len(r.prompt)
        seqs.append(torch.as_tensor(toks, device=device))
        wanted.append(list(range(p - 1, p - 1 + len(r.tokens))))
        served.append(torch.as_tensor(np.asarray(r.tokens, np.int64),
                                      device=device))
    return seqs, wanted, served


def widest_gap(ref_logits, chosen) -> float:
    """max over positions of (best reference logit − the chosen token's)."""
    worst = 0.0
    for lg, tok in zip(ref_logits, chosen):
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(ref_logits, low_logits) -> float:
    """The control's reading: the gap of the lower precision's first
    choice at every position."""
    return widest_gap(ref_logits, [lg.argmax(dim=-1) for lg in low_logits])


def kv_snapshot(engine, k: int, seed: int) -> list:
    """(prompt length, tokens stored, k, v) of up to ``k`` requests that
    ``engine`` (a ``ContinuousEngine``) is decoding: the one with the most
    decoded tokens in the cache, then others drawn from the seed, among
    those with at least one.  ``k``/``v`` (L, n, K, hd) are the pages'
    contents for the n positions stored, copied to the host."""
    cache = engine.cache
    rows = []
    for slot, req in sorted(engine.scheduler.slots.items()):
        n, p = int(cache.seq_lens[slot]), req.prompt_len
        if n > p:
            rows.append((n - p, -slot, slot, req))
    if not rows:
        return []
    rows.sort(reverse=True)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
    pick = rng.choice(len(rows) - 1, size=min(k - 1, len(rows) - 1),
                      replace=False) + 1
    out = []
    for _, _, slot, req in [rows[0]] + [rows[j] for j in sorted(pick)]:
        n, p = int(cache.seq_lens[slot]), req.prompt_len
        ids = torch.as_tensor(
            cache.page_table[slot, :-(-n // cache.page_size)].astype(
                np.int64), device=cache.k_pages.device)

        def stored(pages):
            got = pages[:, ids]
            return got.reshape(got.shape[0], -1, *got.shape[3:])[:, :n].cpu()

        toks = np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.out_tokens[:n - p], np.int64)])
        out.append((p, toks, stored(cache.k_pages), stored(cache.v_pages)))
    return out


def kv_error(ref_kv, got_kv, prompt_lens) -> float:
    """The widest ||got − ref|| / ||ref|| over sequences, layers, K and V,
    and the two stretches of positions: the prompt's and the decoded
    tokens'.  ``ref_kv``/``got_kv``: per sequence (k, v), each (L, n, K,
    hd)."""
    worst = 0.0
    for ref, got, p in zip(ref_kv, got_kv, prompt_lens):
        for r, g in zip(ref, got):
            g = g.to(r.device, torch.float32)
            n = r.shape[1]
            for a, b in ((0, p), (p, n)):
                if b > a:
                    num = (g[:, a:b] - r[:, a:b]).flatten(1).norm(dim=1)
                    den = r[:, a:b].flatten(1).norm(dim=1).clamp_min(1e-30)
                    worst = max(worst, float((num / den).max()))
    return worst
