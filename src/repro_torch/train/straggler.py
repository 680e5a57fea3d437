"""Straggler detection and mitigation.

Copy of ``src/repro/train/straggler.py`` (framework-free); keep the two in
step.

At pod scale one slow host (thermal throttle, failing HBM, noisy neighbour on
DCN) gates every synchronous step. Detection: per-step host timing against a
robust running estimate (median + k*MAD over a window). Mitigation hooks:

  * ``report()`` -> verdict per host (ok / straggler), consumed by the
    launcher to re-shard around the slow host (train.elastic) or by the
    scheduler to mark the device degraded (DeviceState.alive flags);
  * the policy is deliberately decoupled from detection so a deployment can
    choose drop/reshard vs. wait vs. checkpoint-and-migrate.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerVerdict:
    host: int
    median_s: float
    last_s: float
    ratio: float
    is_straggler: bool


class StragglerDetector:
    """Sliding-window median/MAD detector over per-host step times."""

    def __init__(self, n_hosts: int, window: int = 32,
                 threshold: float = 1.5, min_samples: int = 8):
        self.n_hosts = n_hosts
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self._times: List[Deque[float]] = [
            collections.deque(maxlen=window) for _ in range(n_hosts)]

    def record_step(self, host: int, seconds: float) -> None:
        self._times[host].append(seconds)

    @staticmethod
    def _median(xs: List[float]) -> float:
        ys = sorted(xs)
        n = len(ys)
        return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])

    def report(self) -> Dict[int, StragglerVerdict]:
        # global median over all hosts' recent steps = the fleet's pace
        all_times = [t for dq in self._times for t in dq]
        if len(all_times) < self.min_samples:
            return {}
        fleet = self._median(all_times)
        out = {}
        for h, dq in enumerate(self._times):
            if not dq:
                continue
            mine = self._median(list(dq))
            ratio = mine / max(fleet, 1e-12)
            out[h] = StragglerVerdict(
                host=h, median_s=fleet, last_s=mine, ratio=ratio,
                is_straggler=ratio > self.threshold and len(dq) >= 4)
        return out

    def stragglers(self) -> List[int]:
        return [h for h, v in self.report().items() if v.is_straggler]
