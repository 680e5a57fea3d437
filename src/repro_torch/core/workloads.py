"""Workload generation for the paper's evaluation (§V-A): the Rodinia half.

Port of ``src/repro/core/workloads.py:1-214``, with the NN jobs
(``:218-293``) and a copy of the overload trace (``:383-452``,
``_synthetic_job`` and ``overload_mix``, framework-free). Rodinia-analogue
jobs: a library of kernel families with the same resource personalities as the
paper's picks (backprop, srad v1/v2, lavaMD, needle, dwt2d, bfs), written
as PyTorch functions on tensors. Each job's ResourceVector is obtained the
compiler-guided way: ``core.probe`` traces the family on fake tensors of
the working set's shapes (``TensorSpec``), so nothing is allocated and
multi-GB footprints are probed on any host, on the card's device when
there is one (the probe then adds ``CUDA_UNSEEN_BYTES``) or on the CPU when
asked. Durations are the probe's estimate scaled to the paper's 5-10-minute
workloads, so only the footprint and the demands carry over from a probe.

Where the port departs from the reference's probes, each keeps the
family's personality (compute- or bandwidth-bound, the demands of its
``EFFICIENCY`` row):

  * backprop's backward is written out as products (``addmm``,
    ``tanh_backward``): the probe traces under ``torch.no_grad`` and counts
    only what runs, and an autograd gradient would be invisible to it;
  * eager PyTorch counts the bytes of every op where XLA counts a fused
    program, so the estimates and the temporaries differ (lavaMD's
    pair-wise temporaries make most of its footprint); the calibration to
    the target footprint (``_probe_family``) absorbs the latter and the
    rescaling to ``TARGET_JOB_SECONDS`` the former;
  * needle is a scan over ``side`` rows, each the same ops at full width:
    it is traced for ``NEEDLE_ROWS`` and twice as many rows and its flops
    and bytes extended linearly to ``side`` rows (its output is one
    ``[side, side]`` allocation, so its footprint does not grow with the
    rows traced), so a probe costs the same at any footprint.

Mixes (Table I): large = >4 GB footprint, small = 1-4 GB; W1..W8 are
{16, 32} jobs x {1:1, 2:1, 3:1, 5:1} large:small, randomly drawn but
seeded: a seed draws the same families, footprints and duration targets as
in the reference.

The NN jobs of §V-E (``src/repro/core/workloads.py:218-288``) are probed
from the port's own model steps on fake tensors, at the reference's
configurations, shapes, ``work_scale`` and ``efficiency``: predict is
qwen1.5-32b reduced's prefill at 8 x 1024, train gemma2-9b reduced's train
step (forward, backward through the hand kernels' backward ops, AdamW) at
16 x 512, generate musicgen-large reduced's decode step over an 8 x 512
cache (``models.decode.decode_step`` on ``TensorSpec``s of the cache, in
place of the reference's ``make_serve_step`` over ``abstract_cache``), and
detect is derived from predict. Parameters are bf16 and the moments f32,
as the reference's ``abstract_train_state`` makes them; predict and train
take the analytic flops of ``launch/flops.py``, as the reference does.
train's bytes differ by design (ROADMAP C13): the reference compiles its
step with ``flash_jnp``, whose 512-key block is the whole key range at S =
512, so XLA's program materialises the score matrices (7.70e9 B a step by
its cost analysis); the port probes the step it runs, through the fused
flash op that reads q, k, v and writes o and lse (2.72e9 B). The port's
materialising paths count more than XLA (``flash_plain`` 1.65e10, ``naive``
1.29e10: eager PyTorch counts each elementwise pass over the scores, XLA
fuses them), so the reference lies between the two kinds of count;
``tests/test_torch_nn_workloads.py`` holds that.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.probe import (
    TensorSpec, probe_fn, trace_counts, vector_from_counts,
)
from repro_torch.core.task import Job, ResourceVector, Task, UnitTask

GB = 1024**3


# ---------------------------------------------------------------------------
# Rodinia-analogue kernel library
# ---------------------------------------------------------------------------
# Each entry: a kernel over an n-element working set; probes run on
# TensorSpecs of its arguments.

def _k_backprop(x, w1, w2):
    """2-layer MLP fwd+bwd over a chunk (pattern recognition): one step of
    gradient descent on sum((tanh(x w1) w2)^2), the backward as products."""
    h = torch.tanh(x @ w1)
    y = h @ w2
    # dL/dy = 2y; dL/dw2 = h^T 2y; dL/dw1 = x^T ((2y w2^T) * (1 - h^2))
    ga = torch.ops.aten.tanh_backward(y @ w2.T, h)
    return (torch.addmm(w1, x.T, ga, alpha=-2e-3),
            torch.addmm(w2, h.T, y, alpha=-2e-3))


def _k_srad(img):
    """Anisotropic diffusion stencil sweep (image processing)."""
    im = img
    for _ in range(8):
        n = torch.roll(im, 1, 0) + torch.roll(im, -1, 0) \
            + torch.roll(im, 1, 1) + torch.roll(im, -1, 1) - 4 * im
        g = n / (im + 1e-6)
        c = 1.0 / (1.0 + torch.square(g))
        im = im + 0.1 * c * n
    return im


def _k_lavamd(pos, q):
    """All-pairs-in-neighborhood force kernel (molecular dynamics): every
    cell of ``pos`` [cells, c, 3] at once."""
    d = pos[:, :, None, :] - pos[:, None, :, :]        # [cells, c, c, 3]
    r2 = torch.sum(d * d, dim=-1) + 1e-3
    f = q[:, None] * q[None, :] / r2
    return torch.sum(f[..., None] * d, dim=2)


def _k_needle(seq, rows: Optional[int] = None):
    """Wavefront DP over an alignment matrix (bioinformatics): row i of the
    output is max(prev + seq[i], roll(prev, 1) - 1), from prev = seq[0].
    ``rows`` stops after that many rows (the probe's extension)."""
    out = torch.empty_like(seq)
    prev = seq[0]
    for i in range(seq.shape[0] if rows is None else rows):
        prev = torch.maximum(prev + seq[i], torch.roll(prev, 1) - 1.0)
        out[i] = prev
    return out


def _k_dwt2d(img):
    """Separable wavelet transform passes (image/video compression)."""
    lo = (img[:, ::2] + img[:, 1::2]) * 0.5
    hi = (img[:, ::2] - img[:, 1::2]) * 0.5
    lo2 = (lo[::2] + lo[1::2]) * 0.5
    hi2 = (lo[::2] - lo[1::2]) * 0.5
    return lo2, hi2, hi


def _k_bfs(adj, frontier):
    """Sparse frontier expansion as dense matvec rounds (graph)."""
    f, sums = frontier, []
    for _ in range(4):
        f = torch.clip(adj @ f, 0.0, 1.0)
        sums.append(torch.sum(f))
    return f, torch.stack(sums)


# Achieved-efficiency profiles (core_eff, bw_eff): the fraction of peak
# compute / HBM bandwidth each family reaches while running solo. Dense
# matmuls run near the tensor-core roof; stencils reach ~half of stream
# bandwidth; wavefront DP and graph frontier expansion are latency-bound.
# Calibrated to the paper's motivating observation that a typical workload
# uses ~30% of a device (§I) — the mixes below average ~=0.35
# dominant-resource share.
EFFICIENCY = {
    "backprop": (0.85, 0.60),
    "srad_v1": (0.50, 0.45),
    "srad_v2": (0.50, 0.45),
    "lavamd": (0.90, 0.50),
    "needle": (0.30, 0.25),
    "dwt2d": (0.40, 0.35),
    "bfs": (0.25, 0.20),
}
# rows of the needle scan traced (and twice as many) per probe
NEEDLE_ROWS = 4


def probe_device(device=None) -> torch.device:
    """The device a probe's fake tensors live on: the card unless the
    caller asks for the CPU; with no card and no CPU asked for, raise."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to probe on "
                           "the CPU")
    return torch.device("cuda", 0) if device is None \
        else torch.device(device)


def _needle_vector(side: int, device: torch.device) -> ResourceVector:
    """needle's vector at ``side`` rows from traces of ``NEEDLE_ROWS`` and
    twice as many: flops and bytes grow by the same amount a row, the
    footprint not at all."""
    spec = TensorSpec((side, side), torch.float32, device)
    k = min(NEEDLE_ROWS, side // 2)
    a = trace_counts(_k_needle, spec, k)
    b = trace_counts(_k_needle, spec, 2 * k)
    per_row = {key: (b[key] - a[key]) / k
               for key in ("flops", "bytes_accessed")}
    return vector_from_counts(
        hbm_bytes=max(a["hbm_bytes"], b["hbm_bytes"]),
        flops=a["flops"] + (side - k) * per_row["flops"],
        bytes_accessed=a["bytes_accessed"]
        + (side - k) * per_row["bytes_accessed"],
        efficiency=EFFICIENCY["needle"])


def _probe_at(family: str, n: int, device: torch.device) -> ResourceVector:
    """Probe one kernel family at an n-element working set (no
    allocation)."""
    def S(*shape):
        return TensorSpec(shape, torch.float32, device)
    eff = EFFICIENCY[family]
    if family == "backprop":
        d = max(int((n / 6) ** 0.5) // 128 * 128, 256)
        return probe_fn(_k_backprop, S(d, d), S(d, d), S(d, d),
                        efficiency=eff)
    if family in ("srad_v1", "srad_v2"):
        side = max(int((n / 2) ** 0.5) // 128 * 128, 256)
        return probe_fn(_k_srad, S(side, side), efficiency=eff)
    if family == "lavamd":
        cells_ = max(n // (4 * 128), 64)
        return probe_fn(_k_lavamd, S(cells_, 128, 3), S(128),
                        efficiency=eff)
    if family == "needle":
        side = max(int((n / 2) ** 0.5) // 128 * 128, 256)
        return _needle_vector(side, device)
    if family == "dwt2d":
        side = max(int((n / 2) ** 0.5) // 128 * 128, 256)
        return probe_fn(_k_dwt2d, S(side, side), efficiency=eff)
    if family == "bfs":
        side = max(int(n ** 0.5) // 128 * 128, 256)
        return probe_fn(_k_bfs, S(side, side), S(side), efficiency=eff)
    raise KeyError(family)


@functools.lru_cache(maxsize=None)
def _probe_family(family: str, footprint_bytes: int,
                  device: torch.device) -> ResourceVector:
    """Probe a kernel family, CALIBRATING the working-set size until the
    probed footprint (args + temps, which the nominal size underestimates)
    lands within 25% of the target. Footprint is ~linear in n, so 1-3
    fixed-point steps converge."""
    n = footprint_bytes // 4
    vec = _probe_at(family, n, device)
    for _ in range(3):
        ratio = vec.hbm_bytes / footprint_bytes
        if 0.75 <= ratio <= 1.25:
            break
        n = max(int(n / ratio), 1 << 16)
        vec = _probe_at(family, n, device)
    return vec


# paper: 7 combos at 1-4 GB (all but lavaMD), 10 combos > 4 GB (all but bfs)
SMALL_FAMILIES = ["backprop", "srad_v1", "srad_v2", "needle", "dwt2d", "bfs"]
LARGE_FAMILIES = ["backprop", "srad_v1", "srad_v2", "lavamd", "needle",
                  "dwt2d"]
SMALL_RANGE = (1.0 * GB, 4.0 * GB)
LARGE_RANGE = (4.5 * GB, 13.0 * GB)
# calibrate job durations to the paper's 5-10-minute workload scale
TARGET_JOB_SECONDS = (8.0, 40.0)


def make_rodinia_job(rng: np.random.Generator, *, large: bool,
                     name: str, device=None) -> Job:
    fam = rng.choice(LARGE_FAMILIES if large else SMALL_FAMILIES)
    lo, hi = LARGE_RANGE if large else SMALL_RANGE
    # snap footprints to a small grid so the probe cache hits
    foot = int(rng.uniform(lo, hi) / (0.5 * GB)) * int(0.5 * GB)
    base = _probe_family(str(fam), foot, probe_device(device))
    tgt = rng.uniform(*TARGET_JOB_SECONDS)
    vec = base.scaled(tgt / max(base.est_seconds, 1e-9))
    unit = UnitTask(fn=None, memobjs=frozenset({f"{name}/ws"}),
                    resources=vec, name=f"{fam}-{foot // GB}G")
    return Job(tasks=[Task(units=[unit], name=unit.name)], name=name)


def make_mix(seed: int, n_jobs: int, ratio: Tuple[int, int],
             device=None) -> List[Job]:
    """ratio = (large, small), e.g. (3, 1). Jobs randomly drawn, seeded;
    probed on the card unless ``device`` is "cpu"."""
    rng = np.random.default_rng(seed)
    lg, sm = ratio
    jobs = []
    for i in range(n_jobs):
        large = (i % (lg + sm)) < lg
        jobs.append(make_rodinia_job(rng, large=large, name=f"job{i:03d}",
                                     device=device))
    order = rng.permutation(len(jobs))
    return [jobs[i] for i in order]


# Table I: the eight Rodinia workloads
WORKLOADS: Dict[str, Tuple[int, Tuple[int, int]]] = {
    "W1": (16, (1, 1)), "W2": (16, (2, 1)), "W3": (16, (3, 1)),
    "W4": (16, (5, 1)), "W5": (32, (1, 1)), "W6": (32, (2, 1)),
    "W7": (32, (3, 1)), "W8": (32, (5, 1)),
}


def workload(name: str, seed: int = 0, device=None) -> List[Job]:
    n, ratio = WORKLOADS[name]
    # stable per-workload seed (python hash() is salted per process)
    tag = sum(ord(c) * 31 ** i for i, c in enumerate(name)) % 1000
    return make_mix(seed + tag, n, ratio, device=device)


# ---------------------------------------------------------------------------
# NN jobs (§V-E): probed from the port's model substrate
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _nn_vector(kind: str, device: torch.device) -> ResourceVector:
    from torch.utils._pytree import tree_map

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.flops import forward_flops, step_flops
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import decode as D
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.decode import make_prefill_step
    from repro_torch.train.train_step import (
        abstract_train_state, make_train_step,
    )

    if kind == "predict":   # darknet19/53 classification: prefill-like
        cfg = get_arch("qwen1.5-32b").reduced()
        shape = ShapeConfig("nn_predict", 1024, 8, "prefill")
        params, _ = abstract_train_state(cfg, AdamWConfig(), device=device)
        return probe_fn(make_prefill_step(cfg), params,
                        input_specs(cfg, shape, device),
                        flops_override=forward_flops(cfg, 8, 1024),
                        work_scale=400.0, efficiency=(0.18, 0.15))
    if kind == "train":     # CIFAR-small training
        cfg = get_arch("gemma2-9b").reduced()
        shape = ShapeConfig("nn_train", 512, 16, "train")
        opt = AdamWConfig()
        params, opts = abstract_train_state(cfg, opt, device=device)
        return probe_fn(make_train_step(cfg, opt), params, opts,
                        input_specs(cfg, shape, device),
                        flops_override=step_flops(cfg, shape),
                        work_scale=250.0, efficiency=(0.39, 0.30))
    if kind == "detect":    # yolo real-time: tiny, low utilization (<=25%)
        base = _nn_vector("predict", device)
        return dataclasses.replace(base.scaled(0.5), core_demand=0.12,
                                   bw_demand=0.10, hbm_bytes=int(0.6 * GB))
    if kind == "generate":  # RNN text generation: decode-step personality
        cfg = get_arch("musicgen-large").reduced()
        params, _ = abstract_train_state(cfg, AdamWConfig(), device=device)
        cache = tree_map(
            lambda t: TensorSpec(tuple(t.shape), t.dtype, device),
            D.init_cache(cfg, 8, 512, torch.bfloat16, torch.device("meta")))
        return probe_fn(_decode_step(cfg), params, cache,
                        TensorSpec((8,), torch.int32, device),
                        TensorSpec((), torch.int32, device),
                        work_scale=20000.0, efficiency=(0.05, 0.275))
    raise KeyError(kind)


@functools.lru_cache(maxsize=None)
def _decode_step(cfg):
    """One decode step of ``cfg`` (one function per config, so the probe's
    cache keys it)."""
    from repro_torch.models import decode as D

    def serve_step(params, cache, tokens, pos):
        return D.decode_step(params, cfg, cache, tokens, pos)
    return serve_step


NN_KINDS = ("predict", "train", "detect", "generate")
# paper: each NN's device state is 0.5-1.5 GB
_NN_MEM = {"predict": int(1.1 * GB), "train": int(1.5 * GB),
           "detect": int(0.6 * GB), "generate": int(0.5 * GB)}


def make_nn_job(kind: str, idx: int, device=None) -> Job:
    vec = dataclasses.replace(_nn_vector(kind, probe_device(device)),
                              hbm_bytes=_NN_MEM[kind])
    unit = UnitTask(fn=None, memobjs=frozenset({f"nn{idx}/{kind}"}),
                    resources=vec, name=f"{kind}{idx}")
    return Job(tasks=[Task(units=[unit], name=unit.name)], name=f"{kind}{idx}")


def nn_homogeneous(kind: str, n_jobs: int = 8, device=None) -> List[Job]:
    return [make_nn_job(kind, i, device) for i in range(n_jobs)]


def nn_mix(seed: int, n_jobs: int = 128, device=None) -> List[Job]:
    rng = np.random.default_rng(seed)
    return [make_nn_job(str(rng.choice(NN_KINDS)), i, device)
            for i in range(n_jobs)]


# ---------------------------------------------------------------------------
# Overload workloads — the preemption subsystem's evaluation trace
# ---------------------------------------------------------------------------
# An OVERLOADED open-arrival scenario: long memory-heavy background jobs
# saturate the fleet, short urgent deadlined jobs arrive while they run, and
# small low-demand bystanders co-reside throughout. Memory is the binding
# constraint by construction (background + urgent footprints cannot share a
# 16 GB device), so an urgent arrival can only (a) wait out a background job
# many times its length, (b) be shed, or (c) preempt — the three systems
# ``repro_torch.bench.preempt`` compares. Bystanders are small enough to stay
# resident through the churn: their kernel slowdown is the "non-preempted
# degradation" the paper's <=2.5% envelope is checked against.

def _synthetic_job(rng: np.random.Generator, name: str, *,
                   gb: Tuple[float, float], seconds: Tuple[float, float],
                   core: float, bw: float, priority: int = 0) -> Job:
    vec = ResourceVector(
        hbm_bytes=int(rng.uniform(*gb) * GB), flops=1e12,
        bytes_accessed=1e11, est_seconds=float(rng.uniform(*seconds)),
        core_demand=core, bw_demand=bw)
    unit = UnitTask(fn=None, memobjs=frozenset({f"{name}/ws"}),
                    resources=vec, name=name)
    return Job(tasks=[Task(units=[unit], name=name)], name=name,
               priority=priority)


def overload_mix(seed: int, *, n_background: int = 8, n_bystander: int = 4,
                 n_urgent: int = 24, urgent_rate_hz: float = 1.2,
                 bg_gb: Tuple[float, float] = (9.5, 11.0),
                 bg_seconds: Tuple[float, float] = (16.0, 24.0),
                 urgent_gb: Tuple[float, float] = (8.5, 9.5),
                 urgent_seconds: Tuple[float, float] = (0.6, 1.4),
                 urgent_deadline_slack_s: float = 2.0,
                 urgent_priority: int = 5) -> List[Dict]:
    """Seeded overload trace as submission rows
    ``{"t", "job", "priority", "deadline_s", "kind"}`` sorted by arrival.

    Backgrounds (priority 0, no deadline, ~10 GB x ~20 s) and bystanders
    (~1 GB, low demand) arrive in the first two seconds and saturate the
    fleet; urgents (priority ``urgent_priority``, ~9 GB x ~1 s, deadline =
    est + slack) arrive Poisson at ``urgent_rate_hz`` from t=2 onwards.
    ``deadline_s`` is relative to the row's own ``t`` — callers pass it to
    ``Cluster.submit`` at that virtual time (or ignore it for the FIFO
    baseline and only measure against it)."""
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    for i in range(n_background):
        rows.append({"t": float(rng.uniform(0.0, 1.0)),
                     "job": _synthetic_job(rng, f"bg{i:03d}", gb=bg_gb,
                                           seconds=bg_seconds,
                                           core=0.45, bw=0.30),
                     "priority": 0, "deadline_s": None, "kind": "background"})
    for i in range(n_bystander):
        rows.append({"t": float(rng.uniform(0.0, 2.0)),
                     "job": _synthetic_job(rng, f"by{i:03d}", gb=(0.8, 1.5),
                                           seconds=(8.0, 14.0),
                                           core=0.10, bw=0.08),
                     "priority": 0, "deadline_s": None, "kind": "bystander"})
    t = 2.0
    for i in range(n_urgent):
        t += float(rng.exponential(1.0 / urgent_rate_hz))
        job = _synthetic_job(rng, f"urgent{i:03d}", gb=urgent_gb,
                             seconds=urgent_seconds, core=0.50, bw=0.35,
                             priority=urgent_priority)
        rows.append({"t": t, "job": job, "priority": urgent_priority,
                     "deadline_s": job.total_seconds
                     + urgent_deadline_slack_s,
                     "kind": "urgent"})
    rows.sort(key=lambda r: r["t"])
    return rows
