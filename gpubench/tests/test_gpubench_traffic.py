"""The traffic generator: a seed gives the same requests every time, every
seed the same multiset of lengths and gaps, and lengths stay in the mix's
buckets and bounds."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from gpubench import traffic
from gpubench.tests import tiny

MIXES = {p.stem: json.loads(p.read_text()) for p in
         (Path(__file__).resolve().parents[1] / "traffic").glob("*.json")}
# an open loop, as no cell has one yet
MIXES["open"] = dict(tiny.OPEN, prompt={"dist": "lognormal", "median": 512,
                                        "sigma": 0.7,
                                        "buckets": [256, 512, 1024, 2048]})


def _mix(name):
    mix = dict(MIXES[name])
    if mix["loop"] == "open":
        mix["rate_per_s"] = 3.0
    return mix


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_requests(name):
    a = traffic.draws(_mix(name), 2**31 + 11, 40.0, 32000)
    b = traffic.draws(_mix(name), 2**31 + 11, 40.0, 32000)
    assert [(d.prompt_len, d.gen_len, d.due_s) for d in a] == \
        [(d.prompt_len, d.gen_len, d.due_s) for d in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_draws_the_same_work(name):
    a = traffic.draws(_mix(name), 1, 40.0, 32000)
    b = traffic.draws(_mix(name), 987654321987, 40.0, 32000)
    assert Counter(d.prompt_len for d in a) == \
        Counter(d.prompt_len for d in b)
    assert Counter(d.gen_len for d in a) == Counter(d.gen_len for d in b)
    if a[0].due_s is not None:
        assert len(a) == len(b)
        assert a[-1].due_s == pytest.approx(b[-1].due_s, rel=1e-9) or \
            max(d.due_s for d in a) < 40.0
        gaps = sorted(np.diff([0.0] + [d.due_s for d in a]))
        gaps_b = sorted(np.diff([0.0] + [d.due_s for d in b]))
        assert gaps == pytest.approx(gaps_b)
    assert [d.prompt_len for d in a] != [d.prompt_len for d in b]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_lengths_respect_the_mix(name):
    mix = _mix(name)
    draws = traffic.draws(mix, 5, 40.0, 1000)
    buckets = set(mix["prompt"]["buckets"])
    out = mix["output"]
    assert {d.prompt_len for d in draws} <= buckets
    assert all(out["min"] <= d.gen_len <= out["max"] for d in draws)
    assert all(0 <= d.tokens.min() and d.tokens.max() < 1000
               for d in draws)
    assert traffic.max_len(mix) == max(buckets) + out["max"]


def test_open_loop_rate():
    mix = _mix("open")
    draws = traffic.draws(mix, 3, 40.0, 100)
    assert abs(len(draws) - 3.0 * 40.0) <= 2
    assert all(0 < d.due_s < 40.0 for d in draws)
    assert [d.due_s for d in draws] == sorted(d.due_s for d in draws)


def test_lognormal_median():
    xs = traffic.lengths({"dist": "lognormal", "median": 512, "sigma": 0.7},
                         1001)
    assert xs[500] == 512
    assert xs == sorted(xs)
