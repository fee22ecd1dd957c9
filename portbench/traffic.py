"""The one traffic generator: a traffic mix is the ``traffic`` object of a
cell file, and this module turns it, a seed and the benchmark's
``run_seconds`` into requests.

Every seed gets the same set of sizes and gaps in another order: sizes are
the quantiles (i + 0.5) / n of the stated distribution, gaps those of an
exponential at the stated rate, each block of requests permuted by the
seed. So two seeds offer the same work, and a seed changes only its order
and the token ids. Parameters:

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request when its last one completes) or ``"open"`` (Poisson arrivals at
  ``rate_per_s``, sent whether or not earlier ones have finished);
* blocks: an open loop draws ``rate_per_s`` x ``prime_s`` requests for the
  arrivals before the window, then ``cycles`` blocks of ``rate_per_s`` x
  ``run_seconds`` requests (``run_seconds`` is ``BENCHMARK.json``'s), so
  each seed's window offers one whole block; a closed loop draws
  ``cycles`` blocks of ``block`` requests, so a window takes whole blocks
  but for the last;
* ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``, in tokens.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

__all__ = ["LMRequest", "quantile_sizes", "window_block", "lm_requests",
           "arrivals", "residual_outputs"]


@dataclasses.dataclass(frozen=True)
class LMRequest:
    index: int
    tokens: np.ndarray          # prompt ids, int32
    max_new_tokens: int


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def quantile_sizes(spec: dict, n: int) -> np.ndarray:
    """The n quantile sizes of ``spec`` (sorted), as ints."""
    q = _grid(n)
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
        vals = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.rint(vals), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return lo + np.floor(q * (hi - lo + 1)).astype(np.int64)
    raise ValueError(f"unknown size distribution {spec['dist']!r}")


def window_block(traffic: dict, run_seconds: float) -> int:
    """Requests in one block: an open loop's arrivals in one window at its
    rate, or a closed loop's ``block``."""
    if traffic["loop"] == "open":
        return round(float(traffic["rate_per_s"]) * float(run_seconds))
    return int(traffic["block"])


def _blocks(traffic: dict, run_seconds: float) -> list[int]:
    """Sizes of the request blocks in the order they are sent: an open
    loop's priming block first (``rate_per_s`` x ``prime_s``), then
    ``cycles`` blocks of :func:`window_block`."""
    n = window_block(traffic, run_seconds)
    cycles = [n] * int(traffic.get("cycles", 1))
    if traffic["loop"] != "open":
        return cycles
    prime = round(float(traffic["rate_per_s"])
                  * float(traffic.get("prime_s", 0.0)))
    return ([prime] if prime else []) + cycles


def lm_requests(traffic: dict, vocab: int, seed: int,
                run_seconds: float) -> list[LMRequest]:
    """The run's LM requests, in the order they are sent: each block the
    quantile sizes of its own length, in an order drawn from the seed."""
    out: list[LMRequest] = []
    for b, n in enumerate(_blocks(traffic, run_seconds)):
        rng = np.random.default_rng([seed, 1] if b == 0 else [seed, 1, b])
        prompts = rng.permutation(quantile_sizes(traffic["prompt"], n))
        outputs = rng.permutation(quantile_sizes(traffic["output"], n))
        out += [LMRequest(len(out) + i,
                          rng.integers(0, vocab, int(p), dtype=np.int32),
                          int(o))
                for i, (p, o) in enumerate(zip(prompts, outputs))]
    return out


def arrivals(traffic: dict, seed: int, run_seconds: float) -> np.ndarray:
    """Open loop: the arrival offsets in seconds of every request of
    :func:`lm_requests` (Poisson at ``rate_per_s``: each block the
    exponential's quantile gaps, in an order drawn from the seed)."""
    rate = float(traffic["rate_per_s"])
    gaps = [np.random.default_rng([seed, 2, b]).permutation(
                -np.log1p(-_grid(n)) / rate)
            for b, n in enumerate(_blocks(traffic, run_seconds))]
    return np.cumsum(np.concatenate(gaps))


def residual_outputs(outputs: list[int], seed: int) -> list[int]:
    """Closed loop: the first request of each client is already part-way
    through its output when the window opens, so the first wave's lengths
    are cut to a stratified share of their draw and the clients finish at
    staggered times."""
    c = len(outputs)
    share = np.random.default_rng([seed, 3]).permutation(_grid(c))
    return [max(1, int(math.ceil(s * o))) for s, o in zip(share, outputs)]
