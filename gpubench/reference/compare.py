"""The comparison that decides ``correct``: the served tokens of a sample of
finished requests against the plain reference.

For each sampled request the reference runs once over its prompt and the
served tokens checked (all but the last), and reads, at every checked
position, how far the served token's logit lies below the reference's
best logit there. The sample holds the longest request whole and short
prefixes of others, so that it spans the decode loop's rows. The numbers a cell compares are the widest such gap
over the sample and their mean (``gpubench/limits/<cell>.json`` says
which, and their limits). The control reads the same gaps for the tokens
that the control's own logits put first
(``gpubench/reference/precision.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from gpubench.reference import model as R
from gpubench.reference.precision import fp8_mm


@dataclasses.dataclass
class Checked:
    """A request as the reference checks it: its prompt's ids and the
    served ids checked (all of them, or the first ``prefix``)."""
    tokens: Sequence[int]
    served: Sequence[int]


def sample(finished: Sequence, seed: int, n_requests: int,
           prefix: int) -> List[Checked]:
    """The requests to check, drawn from ``seed``: the longest (prompt plus
    served tokens) with all its served tokens, then up to ``n_requests`` -
    1 others in a seeded order, each with its first ``prefix`` served
    tokens, so that the sample spreads over the loop's rows. Each
    ``finished`` item has ``tokens`` (the prompt's ids) and ``served`` (the
    served ids)."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i].tokens)
                                   + len(finished[i].served)))
    rest = [order[i] for i in
            np.random.default_rng(seed).permutation(len(order) - 1) + 1]
    first = finished[order[0]]
    picked = [Checked(first.tokens, list(first.served))]
    for i in rest[:n_requests - 1]:
        picked.append(Checked(finished[i].tokens,
                              list(finished[i].served)[:prefix]))
    return picked


@torch.no_grad()
def token_gaps(params: Dict, c: Dict, checked: Sequence, device,
               control: bool = False) -> Dict[str, float]:
    """Over the served tokens of ``checked``: ``token_gap``, the widest gap
    of a served token below the reference's best, and ``mean_token_gap``,
    the mean gap (0 where the served token is the reference's best); with
    ``control``, the same two of the control's first choices
    (``control_token_gap``, ``control_mean_token_gap``); and ``tokens``,
    the served tokens checked."""
    out = {"token_gap": 0.0, "mean_token_gap": 0.0, "tokens": 0}
    if control:
        out.update(control_token_gap=0.0, control_mean_token_gap=0.0)
    for item in checked:
        served = torch.as_tensor(list(item.served), dtype=torch.long,
                                 device=device)
        seq = torch.cat([torch.as_tensor(item.tokens, dtype=torch.long,
                                         device=device), served[:-1]])
        g = int(served.numel())
        ref = R.logits(params, c, seq[None], g)[0]              # [G, V]
        best = ref.max(-1).values
        rows = torch.arange(g, device=device)
        gaps = best - ref[rows, served]
        out["token_gap"] = max(out["token_gap"], float(gaps.max()))
        out["mean_token_gap"] += float(gaps.sum())
        out["tokens"] += g
        if control:
            pick = R.logits(params, c, seq[None], g, mm=fp8_mm)[0] \
                .argmax(-1)
            ctl = best - ref[rows, pick]
            out["control_token_gap"] = max(out["control_token_gap"],
                                           float(ctl.max()))
            out["control_mean_token_gap"] += float(ctl.sum())
        del ref
    for k in ("mean_token_gap", "control_mean_token_gap"):
        if k in out and out["tokens"]:
            out[k] /= out["tokens"]
    return out
