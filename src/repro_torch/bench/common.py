"""Shared benchmark harness: scheduler comparisons over the paper's
workloads, with the paper's own protocol (worker-pool sizing, CG sweeps).

Copy of ``benchmarks/common.py`` with its imports rewritten to
``repro_torch``, a ``device`` argument for the probes and a command line
(``cli``); keep the two in step.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import workloads as W
from repro_torch.core.scheduler import (
    CGScheduler, MemOnlyScheduler, MGBAlg2Scheduler, MGBAlg3Scheduler,
    SAScheduler,
)
from repro_torch.core.simulator import SimResult, Simulator

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")

# the paper's two systems: 2xP100 and 4xV100 (16 GB each). Worker-pool sizes
# per §V-A: SA = n_gpus; MGB = 10 (2-GPU) / 16 (4-GPU).
SYSTEMS = {"2xP100": 2, "4xV100": 4}
MGB_WORKERS = {"2xP100": 10, "4xV100": 16}


def fresh(jobs: Sequence) -> List:
    return [copy.deepcopy(j) for j in jobs]


def run_sa(jobs, n_dev: int) -> SimResult:
    return Simulator(SAScheduler(n_dev), workers=n_dev).run(fresh(jobs))


def run_mgb(jobs, n_dev: int, workers: int, alg: int = 3) -> SimResult:
    cls = MGBAlg3Scheduler if alg == 3 else MGBAlg2Scheduler
    return Simulator(cls(n_dev), workers=workers).run(fresh(jobs))


def run_memonly(jobs, n_dev: int, workers: int) -> SimResult:
    return Simulator(MemOnlyScheduler(n_dev), workers=workers).run(fresh(jobs))


def run_cg(jobs, n_dev: int, workers: int) -> SimResult:
    """CG with ratio = workers / n_dev (paper: 1 worker per core feeding)."""
    ratio = max(1, workers // n_dev)
    return Simulator(CGScheduler(n_dev, ratio=ratio),
                     workers=workers).run(fresh(jobs))


def best_cg(jobs, n_dev: int,
            worker_sweep: Sequence[int]) -> Tuple[Optional[SimResult], int]:
    """Paper protocol: sweep CG worker pools, take the best run that did NOT
    crash; if every setting crashes, the best-throughput crashing run."""
    best, best_w = None, 0
    best_crashing, best_crashing_w = None, 0
    for w in worker_sweep:
        r = run_cg(jobs, n_dev, w)
        if r.crashed == 0:
            if best is None or r.throughput > best.throughput:
                best, best_w = r, w
        else:
            if best_crashing is None or r.throughput > best_crashing.throughput:
                best_crashing, best_crashing_w = r, w
    if best is not None:
        return best, best_w
    return best_crashing, best_crashing_w


def save_json(name: str, payload) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def check(label: str, value: float, lo: float, hi: float) -> str:
    ok = lo <= value <= hi
    return (f"  {'PASS' if ok else 'MISS':4s} {label}: {value:.2f} "
            f"(paper band [{lo:.2f}, {hi:.2f}])")


def cli() -> dict:
    """The scripts' command line: ``--device cpu`` probes on the CPU
    (default: the card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="probe on the CPU (default: CUDA)")
    return {"device": ap.parse_args().device}
