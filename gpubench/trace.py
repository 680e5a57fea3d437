"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over the last ``TRACE_S`` seconds of the window, and the reduction of its
events to what the per-layer readers and the result line need.

The harness's own spans (``torch.profiler.record_function``) mark what the
host was doing: ``gpubench.window`` the traced window, ``submit`` (the
engine's probe of a request), ``pump`` (one decode step of the loop),
``wait`` (the harness idle until the next arrival) and ``prefill`` (the
runner of a prefill task on a pool worker).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_S = 3.0
WINDOW_SPAN = "gpubench.window"
SPANS = ("submit", "pump", "wait", "prefill")


def _profile(**kw):
    """The profiler over the card and every host thread: the prefills run
    on the executor's pool threads, which a profiler limited to the thread
    that starts it would not see."""
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True), **kw)


class DeviceTrace:
    def __init__(self) -> None:
        self.prof = None
        self._span = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up, so the window's
        start does not pay CUPTI's first initialisation."""
        with _profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = _profile(record_shapes=True)
        self.prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.stop()

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _short(name: str) -> str:
    """A kernel's name without its argument list or template arguments:
    the characters outside every pair of ``<>`` and ``()``, so a name cut
    short or holding ``(anonymous namespace)`` inside its template
    arguments still reduces."""
    out, angle, paren = [], 0, 0
    for ch in name:
        if ch == "(":
            paren += 1
        elif ch == ")":
            paren = max(0, paren - 1)
        elif paren:
            continue
        elif ch == "<":
            angle += 1
        elif ch == ">":
            angle = max(0, angle - 1)
        elif not angle:
            out.append(ch)
    short = " ".join("".join(out).split())
    if short.startswith("void "):
        short = short[5:]
    return (short or name)[:80]


def summarize(events) -> Dict:
    """Reduce the raw profiler events to:

      * ``window_s``, ``busy_s``: the traced window's length and the
        seconds of it in which any device activity (kernel, copy, set) ran;
      * ``device_ops``: device seconds by the program op that launched the
        kernel and the kernel's name (``op / kernel``; the kernel's name
        alone where no op did, as in a replayed graph), largest first;
      * ``idle_gaps``: idle device seconds by the harness spans open at
        each gap's middle (``+``-joined; ``none`` where none was);
      * ``ops``: per program op name, a list of (input shapes, input
        dtypes, device seconds of the kernels it launched) for every call
        in the window that launched any kernel.
    """
    w0 = w1 = None
    cpu_ops = {}
    op_names: Dict[int, str] = {}
    spans: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str, int]] = []
    for ev in events:
        dt = ev.device_type()
        if dt == torch.autograd.DeviceType.CPU:
            name = ev.name()
            if name == WINDOW_SPAN:
                w0, w1 = ev.start_ns(), ev.end_ns()
            elif name in SPANS:
                spans.append((ev.start_ns(), ev.end_ns(), name))
            else:
                op_names[ev.correlation_id()] = name
                if name.startswith("repro_torch::"):
                    cpu_ops[ev.correlation_id()] = (name, ev.shapes(),
                                                    ev.dtypes())
        elif not ev.is_user_annotation():
            # (a span's mirror on the device's timeline is no device work)
            device.append((ev.start_ns(), ev.end_ns(), ev.name(),
                           ev.linked_correlation_id()))
    if w0 is None:
        raise RuntimeError("the traced window's span is missing")
    busy_iv, by_name = [], defaultdict(float)
    ops: Dict[str, List] = defaultdict(list)
    launched: Dict[int, float] = defaultdict(float)
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy_iv.append((s, e))
        op = op_names.get(corr) if corr else None
        label = f"{op} / {_short(name)}" if op else _short(name)
        by_name[label[:80]] += (e - s) / 1e9
        if corr in cpu_ops:
            launched[corr] += (e - s) / 1e9
    for corr, secs in launched.items():
        name, shapes, dtypes = cpu_ops[corr]
        ops[name].append((shapes, dtypes, secs))
    merged = _merge(busy_iv)
    busy = sum(e - s for s, e in merged) / 1e9
    # sweep the spans' starts and ends along the gaps, in time order
    marks = sorted([(a, 1, n) for a, _, n in spans]
                   + [(b, -1, n) for _, b, n in spans])
    open_count: Dict[str, int] = defaultdict(int)
    gaps, prev, k = defaultdict(float), w0, 0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            mid = (s + prev) // 2
            while k < len(marks) and marks[k][0] <= mid:
                open_count[marks[k][2]] += marks[k][1]
                k += 1
            label = "+".join(sorted(n for n, c in open_count.items() if c))
            gaps[label or "none"] += (s - prev) / 1e9
        prev = max(prev, e)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        "ops": dict(ops),
    }
