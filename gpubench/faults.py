"""Faults planted in the timed path, to see ``correct`` come out false under
each: the CPU tests (``gpubench/tests/test_gpubench_faults.py``) and
``gpubench.calibrate --fault`` on the card use the same ones.

  * ``frozen``: a decode step that returns the loop's state unchanged;
  * ``half``: the later half of the rows in use (all of a lone row) left out
    of the step, keeping the token they had;
  * ``altered``: a token altered where it is produced (each prefill's first
    token, one up).

The two step faults wrap ``repro_torch.serve.engine.loop_step`` with tensor
operations alone, so the card's captured step graph records them too; set
them before the engine is built.
"""
from __future__ import annotations

from typing import Callable

import torch


def frozen(step: Callable) -> Callable:
    def frozen_step(params, cfg, cache, tokens, pos, active):
        before = {k: t.clone() for k, t in cache.items()}
        step(params, cfg, cache, tokens, pos, active)
        for k, t in cache.items():
            t.copy_(before[k])
    return frozen_step


def half(step: Callable) -> Callable:
    def half_step(params, cfg, cache, tokens, pos, active):
        keep = tokens.clone()
        step(params, cfg, cache, tokens, pos, active)
        rank = torch.cumsum(active, 0) - 1   # a row's place among those in use
        out = (active > 0) & (rank >= active.sum() // 2)
        tokens.copy_(torch.where(out, keep, tokens))
    return half_step


def altered(model) -> None:
    prefill = model.prefill

    def altered_prefill(req):
        prefill(req)
        req.first_token = (req.first_token + 1) % model.cfg.vocab
    model.prefill = altered_prefill


STEP_FAULTS = {"frozen": frozen, "half": half}
