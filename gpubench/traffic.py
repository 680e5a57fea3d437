"""The one traffic generator: reads a mix's parameters
(``gpubench/traffic/<mix>.json``) and turns them into the requests of one
run, from ``--seed``.

Every seed gets the same multiset of prompt lengths, output lengths and
gaps between arrivals, each drawn by stratified quantiles of the mix's
distributions; the seed only orders them and picks the prompts' token
ids. So two seeds do the same work in another order, and runs spread by
the system's noise, not by the draw.

Mix keys:

  * ``loop``: ``"open"`` (arrivals on a schedule, ``rate_per_s``, Poisson
    gaps) or ``"closed"`` (``clients`` callers, each sending its next
    request when the last one is done, from a shuffled ``pool`` of
    requests, reused from the start if the window outlasts it);
  * ``prompt``, ``output``: a distribution, ``{"dist": ...}`` with
    ``lognormal`` (``median``, ``sigma``), ``uniform`` (``min``, ``max``),
    ``loguniform`` (``min``, ``max``) or ``buckets`` (uniform over the
    list); a prompt length is snapped to the nearest of ``buckets`` when
    the entry has them, an output length clipped to ``min`` .. ``max``;
  * ``max_batch``, ``prefill_workers``, ``slo`` (``ttft_s``, ``tpot_s``):
    the engine's settings, read by the harness.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Draw:
    """One request to send: its prompt's token ids, the tokens to serve
    (the prefill's first one included) and, in an open loop, when it is
    due, in seconds from the window's start."""
    tokens: np.ndarray
    gen_len: int
    due_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


def _quantiles(n: int) -> List[float]:
    return [(i + 0.5) / n for i in range(n)]


def _snap(x: float, buckets: Sequence[int]) -> int:
    return min(buckets, key=lambda b: (abs(b - x), b))


def lengths(spec: Mapping, n: int) -> List[int]:
    """``n`` lengths at the stratified quantiles of ``spec``'s
    distribution, in ascending order."""
    kind = spec["dist"]
    qs = _quantiles(n)
    if kind == "lognormal":
        nd = statistics.NormalDist()
        xs = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q))
              for q in qs]
    elif kind == "uniform":
        lo, hi = spec["min"], spec["max"]
        xs = [lo + math.floor(q * (hi - lo + 1)) for q in qs]
    elif kind == "loguniform":
        lo, hi = spec["min"], spec["max"]
        xs = [lo * (hi / lo) ** q for q in qs]
    elif kind == "buckets":
        bs = sorted(spec["buckets"])
        xs = [bs[min(int(q * len(bs)), len(bs) - 1)] for q in qs]
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    if "buckets" in spec:
        out = [_snap(x, spec["buckets"]) for x in xs]
    else:
        out = [int(round(x)) for x in xs]
    lo, hi = spec.get("min"), spec.get("max")
    return [min(max(v, lo if lo is not None else v),
                hi if hi is not None else v) for v in out]


def buckets(mix: Mapping) -> List[int]:
    """Every prompt length the mix can send (what set-up warms)."""
    spec = mix["prompt"]
    if "buckets" in spec:
        return sorted(set(spec["buckets"]))
    return sorted(set(lengths(spec, 1024)))


def max_len(mix: Mapping) -> int:
    """The longest prompt plus the longest output: the decode loop's
    depth."""
    out = mix["output"]
    return max(buckets(mix)) + (out["max"] if "max" in out
                                else max(lengths(out, 1 << 16)))


def draws(mix: Mapping, seed: int, seconds: float, vocab: int) -> List[Draw]:
    """The run's requests. Open loop: those due in the first ``seconds``,
    with their due times. Closed loop: the shuffled pool, in the order
    the clients take it."""
    rng = np.random.default_rng(seed)
    if mix["loop"] == "open":
        rate = float(mix["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        gaps = [-math.log(1.0 - q) / rate for q in _quantiles(n)]
        gaps = [gaps[i] for i in rng.permutation(n)]
        due = list(np.cumsum(gaps))
    elif mix["loop"] == "closed":
        n = int(mix["pool"])
        due = [None] * n
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    prompts = lengths(mix["prompt"], n)
    outputs = lengths(mix["output"], n)
    prompts = [prompts[i] for i in rng.permutation(n)]
    outputs = [outputs[i] for i in rng.permutation(n)]
    out = []
    for s, g, t in zip(prompts, outputs, due):
        if t is not None and t >= seconds:
            continue
        out.append(Draw(tokens=rng.integers(0, vocab, s, dtype=np.int64),
                        gen_len=int(g), due_s=None if t is None
                        else float(t)))
    return out
