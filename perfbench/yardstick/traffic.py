"""The one traffic generator: it reads a mix (``perfbench/traffic/<mix>.json``)
and makes the requests of one run from ``--seed``.

Every seed gets the same requests, in another order: lengths and gaps
are the distribution's quantiles at (i + ½)/n, laid out in one fixed
random order (the mix's pattern, the same for every seed: a Poisson
process's bursts and lulls), which the seed reorders within blocks of a
few consecutive requests; the seed also draws the prompts' token ids.
The ramp before the window and the window itself are two such sets, so
the work due in the window, and where its bursts fall, are the same for
every seed.  (A free permutation moves the bursts, and with them the
tails, by far more than two runs of one seed differ.)

Mix keys:

* ``loop``: ``"open"`` (arrivals on a wall-clock schedule, whatever the
  server does; the rate comes from the cell) or ``"closed"`` (the next
  batch is sent when one ends);
* ``arrivals`` (open): ``"poisson"``, exponential gaps of mean 1/rate;
* ``prompt_len`` / ``output_len``: a length distribution, one of
  ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
  ``{"dist": "uniform", "min", "max"}`` (whole numbers, both ends in) or
  ``{"dist": "fixed", "value"}``;
* ``batch`` (closed): sequences a batch.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()
#: Seeds the fixed pattern of every open mix
PATTERN = 20251118
#: How many consecutive requests of the pattern a seed reorders
REORDER_BLOCK = 2


def length_quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` whole lengths at the quantiles (i + ½)/n of ``dist``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if kind == "uniform":
        lo, hi = int(dist["min"]), int(dist["max"])
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(
            np.int64)
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        v = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
        return np.clip(v, dist["min"], dist["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def max_length(dist: dict) -> int:
    """The longest length ``dist`` can give."""
    return int(dist["value"] if dist["dist"] == "fixed" else dist["max"])


@dataclasses.dataclass
class Planned:
    """One request of an open-loop schedule: due ``due_s`` after the
    schedule starts."""

    rid: int
    due_s: float
    prompt: np.ndarray
    max_new: int


def _reorder(a: np.ndarray, block: int, rng: np.random.Generator):
    """``a`` with each run of ``block`` consecutive entries shuffled."""
    return np.concatenate([rng.permutation(a[i:i + block])
                           for i in range(0, len(a), block)])


def _phase(mix: dict, rate: float, start: float, span: float, phase: int,
           rng: np.random.Generator, vocab: int, rid: int) -> list[Planned]:
    """round(rate·span) requests due in [start, start + span): exponential
    gaps at their quantiles, scaled to fill the span exactly (the first
    request half its gap in), in the mix's fixed Poisson pattern, which the
    seed reorders within blocks of ``REORDER_BLOCK`` requests; prompt and
    output lengths likewise, each apart."""
    n = max(1, round(rate * span))
    u = (np.arange(n) + 0.5) / n
    pattern = np.random.default_rng([PATTERN, phase])
    def order(values):
        return _reorder(pattern.permutation(values), REORDER_BLOCK, rng)

    gaps = order(-np.log1p(-u))
    gaps *= span / gaps.sum()
    due = start + np.cumsum(gaps) - gaps[0] / 2
    plen = order(length_quantiles(mix["prompt_len"], n))
    olen = order(length_quantiles(mix["output_len"], n))
    return [Planned(rid + i, float(due[i]),
                    rng.integers(0, vocab, int(plen[i]), dtype=np.int32),
                    int(olen[i])) for i in range(n)]


def open_schedule(mix: dict, rate: float, ramp_s: float, window_s: float,
                  seed: int, vocab: int) -> list[Planned]:
    """The requests of a run at ``rate`` a second: the ramp's, due in
    [0, ramp_s), then the window's, due in [ramp_s, ramp_s + window_s).
    Each phase holds the same requests for every seed (its count, gaps
    and lengths are fixed, and so is where its bursts fall), in the seed's
    order within blocks."""
    if mix["loop"] != "open" or mix.get("arrivals") != "poisson":
        raise ValueError("open_schedule wants an open Poisson mix")
    rng = np.random.default_rng(seed)
    ramp = (_phase(mix, rate, 0.0, ramp_s, 0, rng, vocab, 0) if ramp_s
            else [])
    return ramp + _phase(mix, rate, ramp_s, window_s, 1, rng, vocab,
                         len(ramp))


class ClosedBatches:
    """Batches of a closed-loop mix, made one at a time from the seed:
    (tokens (batch, S) int32, new tokens)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix["loop"] != "closed":
            raise ValueError("ClosedBatches wants a closed mix")
        for key in ("prompt_len", "output_len"):
            if mix[key]["dist"] != "fixed":
                raise ValueError(f"a closed batch has one {key}")
        self.batch = int(mix["batch"])
        self.prompt_len = int(mix["prompt_len"]["value"])
        self.new = int(mix["output_len"]["value"])
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)

    def next(self) -> np.ndarray:
        """The next batch's prompts."""
        return self.rng.integers(0, self.vocab,
                                 (self.batch, self.prompt_len),
                                 dtype=np.int32)
