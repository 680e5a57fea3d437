"""Shared arithmetic of the metric readers (``gpubench/metrics/*.py``).

A reader takes the run's ``harness.Context`` and returns a number, or
None where the run gave it nothing to read (the harness then leaves the
metric out of the line).
"""
from __future__ import annotations

import statistics
from typing import List, Optional

from gpubench import roofline


def window_tokens(ctx) -> int:
    """Prompt tokens of every prefill that finished in the window, and
    every token emitted in it."""
    return sum(s.draw.prompt_len for s in ctx.sent if s.first_in_window) \
        + sum(s.tokens_at_close for s in ctx.sent)


def window_flops(ctx) -> float:
    """Model FLOPs (matrix products, ``roofline``) of the tokens that
    ``window_tokens`` counts: each finished prefill's prompt, and each
    decoded token at its context."""
    c = ctx.flat
    f0 = roofline.decode_flops(c, 0)
    slope = roofline.decode_flops(c, 1) - f0
    total = 0.0
    for s in ctx.sent:
        if s.first_in_window:
            total += roofline.prefill_flops(c, s.draw.prompt_len)
        k = s.tokens_at_close - 1  # decoded after the prefill's token
        if k > 0:
            # contexts prompt_len .. prompt_len + k - 1
            mean_ctx = s.draw.prompt_len + (k - 1) / 2.0
            total += k * (f0 + slope * mean_ctx)
    return total


def mfu(ctx) -> float:
    return 100.0 * window_flops(ctx) / ctx.seconds / roofline.H100_BF16_FLOPS


def _task_times(ctx, first: str, second: str) -> List[float]:
    """Per prefill task of a window request, the seconds from its
    ``first`` event to its ``second``, where both fall in the window."""
    if ctx.events is None:
        return []
    names = {f"prefill/{s.req.rid}" for s in ctx.sent}
    at = {}
    for ev in ctx.events:
        if ev.name in names and ev.kind in (first, second):
            at.setdefault((ev.name, ev.kind), ev.t)
    out = []
    for name in names:
        a, b = at.get((name, first)), at.get((name, second))
        if a is not None and b is not None and ctx.t0 <= a and b <= ctx.t1:
            out.append(b - a)
    return out


def prefill_ms(ctx) -> Optional[float]:
    xs = _task_times(ctx, "begin", "end")
    return 1e3 * statistics.median(xs) if xs else None


def decode_step_ms(ctx) -> Optional[float]:
    return 1e3 * ctx.step_s / ctx.steps if ctx.steps else None


def idle_share(ctx) -> Optional[float]:
    if ctx.device is None or not ctx.device["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.device["busy_s"] / ctx.device["window_s"])


def op_roofline(ctx, op: str, bound) -> Optional[float]:
    """Share of the roofline of the program op ``op`` over its calls in the
    traced window: the sum of ``bound(shapes, dtypes)`` over the calls
    against the device time of the kernels they launched."""
    if ctx.device is None:
        return None
    calls = ctx.device["ops"].get(op, [])
    busy = sum(secs for _, _, secs in calls)
    if not busy:
        return None
    return 100.0 * sum(bound(sh, dt) for sh, dt, _ in calls) / busy


def element_bytes(dtype: str) -> int:
    return roofline.ELEMENT_BYTES[dtype]
