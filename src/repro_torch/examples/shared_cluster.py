"""Scenario: a shared accelerator node running a mixed batch of REAL model
workloads (train steps, prefill) from independent "users" under the
paper's scheduler — the full compiler-guided pipeline with live PyTorch
execution through the event-driven executor (blocked jobs hold no thread;
completions wake the waiter queue), plus a mid-run device failure to
exercise the fault-tolerance path and a request fleet far larger than the
execution pool.

Port of ``examples/shared_cluster.py``. What differs:

  * the models are the port's reduced configs with weights drawn from a
    ``torch.Generator`` seeded as the reference seeds ``PRNGKey`` (other
    numbers: tests carry JAX weights over with ``convert``), and attention
    is the hand kernel (``attn_impl="flash_kernel"``, where the reference
    runs ``flash_jnp``): on a card the jobs and the fleet launch all four
    kernels (flash attention and RMSNorm forward and backward from the
    train jobs and every prefill, the grouped matmul from mixtral's MoE
    layer, the scan from falcon-mamba and zamba2);
  * the scheduler's 2 virtual devices map onto the one card (or the CPU),
    so ``mark_dead(0)`` moves work from one virtual device to the other on
    the same card;
  * device 0 dies as the first job's runner starts, where the reference
    sleeps 0.3 s first: on a card the whole run takes about that long, so
    a timed death could land before any task ran or after the last;
  * each job's ``est`` is the probe's roofline estimate on the H100's
    datasheet peaks (``core/probe.py``), labelled so, where the reference
    prints its TPU estimate;
  * ``main`` returns what it prints, and each job's outputs (a train job's
    losses, grad norms and final state, a prefill's logits) stay in its
    ``ModelJob.out``.

    PYTHONPATH=src python -m repro_torch.examples.shared_cluster [--device cpu]
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob, Executor
from repro_torch.core.probe import probe_fn
from repro_torch.core.scheduler import MGBAlg3Scheduler, SAScheduler
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.data.pipeline import to_device
from repro_torch.examples import cli, device_name
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.serve.decode import make_prefill_step
from repro_torch.train.train_step import make_train_step

BATCH, SEQ = 4, 128
TRAIN_ARCHS = ("gemma2-9b", "qwen1.5-32b")
SERVE_ARCHS = ("mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b",
               "musicgen-large")
ATTN_IMPL = "flash_kernel"
FLEET_REQUESTS = 64  # the streamed fleet's requests, as the reference's


@dataclasses.dataclass
class ModelJob:
    """A live job and what its runner leaves behind: a train job's
    ``params``, ``opt``, ``losses`` and ``grad_norms``; a prefill's
    ``logits``."""
    ej: ExecJob
    out: dict


def _single(name: str, vec, runner) -> ExecJob:
    unit = UnitTask(fn=None, memobjs=frozenset({name}), resources=vec,
                    name=name)
    return ExecJob(job=Job(tasks=[Task(units=[unit], name=name)], name=name),
                   runners=[runner])


def _batch(cfg, rng: np.random.Generator, b: int, s: int, device,
           labels: bool) -> dict:
    """Tokens (and labels, and a frontend stub's ``embeds``) drawn from
    ``rng`` in the reference's order."""
    tok = rng.integers(0, cfg.vocab, (b, s), np.int32)
    batch = {"tokens": tok}
    if labels:
        batch["labels"] = np.roll(tok, -1, axis=1)
    if cfg.embedding_frontend_stub:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model),
                                              np.float32)
    return to_device(batch, device)


def _params(cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, torch.float32, device)


def make_train_job(arch: str, idx: int, device, params=None,
                   steps: int = 3) -> ModelJob:
    """``steps`` AdamW steps of reduced ``arch`` on one batch, probed with
    ``work_scale=steps``; weights from seed ``idx`` unless ``params`` are
    given (on ``device``)."""
    cfg = get_arch(arch).reduced()
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(cfg, opt_cfg, attn_impl=ATTN_IMPL)
    if params is None:
        params = _params(cfg, idx, device)
    opt_state = adamw.init_state(opt_cfg, params)
    batch = _batch(cfg, np.random.default_rng(idx), BATCH, SEQ, device,
                   labels=True)
    vec = probe_fn(step, params, opt_state, batch, work_scale=steps)
    # shared by every attempt, as in the reference: a re-dispatched
    # attempt (after a device death) trains on from where the last stopped
    out = {"params": params, "opt": opt_state, "losses": [],
           "grad_norms": []}

    def runner(dev):
        metrics = []
        for _ in range(steps):
            out["params"], out["opt"], m = step(out["params"], out["opt"],
                                                batch)
            metrics.append(m)
        out["losses"] += [float(m["loss"]) for m in metrics]
        out["grad_norms"] += [float(m["grad_norm"]) for m in metrics]

    return ModelJob(_single(f"train-{arch}-{idx}", vec, runner), out)


def make_serve_job(arch: str, idx: int, device, params=None) -> ModelJob:
    """One prefill of reduced ``arch`` at ``BATCH`` x ``SEQ``; weights from
    seed ``100 + idx`` unless ``params`` are given (on ``device``)."""
    cfg = get_arch(arch).reduced()
    prefill = make_prefill_step(cfg, attn_impl=ATTN_IMPL)
    if params is None:
        params = _params(cfg, 100 + idx, device)
    batch = _batch(cfg, np.random.default_rng(100 + idx), BATCH, SEQ,
                   device, labels=False)
    vec = probe_fn(prefill, params, batch)
    out = {}

    def runner(dev):
        out["logits"], _ = prefill(params, batch)

    return ModelJob(_single(f"serve-{arch}-{idx}", vec, runner), out)


def _signalling(runner, begun: threading.Event):
    """``runner`` that sets ``begun`` as it starts."""
    def run(dev):
        begun.set()
        return runner(dev)
    return run


def build_jobs(device) -> List[ModelJob]:
    jobs = [make_train_job(arch, i, device)
            for i, arch in enumerate(TRAIN_ARCHS)]
    jobs += [make_serve_job(arch, i, device)
             for i, arch in enumerate(SERVE_ARCHS)]
    return jobs


def fleet(device) -> dict:
    """``FLEET_REQUESTS`` zamba2-2.7b prefills at priority 5 (deadline 30 s),
    streamed to a 2-worker ``Cluster`` beside a background gemma2-9b train
    job: ``done``, ``stats``, ``wall_s``, the background's status and the
    first request's record count."""
    # the serving-scale path: every request is a task submitted to the live
    # Cluster AS IT ARRIVES — no pre-declared batch. Blocked requests park
    # in the scheduler's admission queue (no thread each) and completions
    # wake the next admission. Requests are submitted at priority 5 so
    # they outrank the background training job streamed alongside them, and
    # each request carries a deadline (EDF within the priority class). One
    # prefill step is shared by the whole fleet.
    cfg = get_arch("zamba2-2.7b").reduced()
    prefill = make_prefill_step(cfg, attn_impl=ATTN_IMPL)
    params = _params(cfg, 0, device)
    fleet_batch = _batch(cfg, np.random.default_rng(0), 2, 32, device,
                         labels=False)
    vec = probe_fn(prefill, params, fleet_batch)

    def decode_runner(dev):
        prefill(params, fleet_batch)

    t0 = time.time()
    with Cluster(MGBAlg3Scheduler(num_devices=2), workers=2,
                 devices=[device]) as cluster:
        background = cluster.submit(
            make_train_job("gemma2-9b", 7, device).ej, priority=0)
        handles = [cluster.submit(_single(f"decode-{i}", vec, decode_runner),
                                  priority=5, deadline_s=30.0)
                   for i in range(FLEET_REQUESTS)]
        first = handles[0].result(timeout=60)   # a single request's future
        cluster.drain()
        stats = cluster.stats()
    done = sum(1 for h in handles if h.status is JobStatus.DONE)
    return {"done": done, "stats": stats, "wall_s": time.time() - t0,
            "background": background.status.value, "first": len(first)}


def main(argv=None) -> dict:
    """Returns each job's probe (``jobs``: name, hbm bytes, demand, est
    seconds), the sections' stats (``mgb``, ``sa``, ``fault``), MGB's
    ``per_device`` task counts, the ``speedup`` of MGB over SA, the
    ``evicted`` count of the device death, and the ``fleet``'s figures."""
    _, device = cli(argv)
    print("building 6 jobs (2 train + 4 serve) from 6 architectures...")
    jobs = build_jobs(device)
    probes = []
    for j in jobs:
        r = j.ej.job.tasks[0].resources
        probes.append((j.ej.job.name, r.hbm_bytes, r.demand, r.est_seconds))
        print(f"  {j.ej.job.name:24s} mem={r.hbm_bytes / 1e6:7.1f} MB "
              f"demand={r.demand:.2f} est={r.est_seconds * 1e3:.2f} ms "
              f"(H100 datasheet)")

    print("\n-- MGB Alg.3 on 2 virtual devices --")
    sched = MGBAlg3Scheduler(num_devices=2)
    stats = Executor(sched, workers=4, devices=[device]).run(
        [j.ej for j in jobs])
    print(f"completed={stats['completed']} crashed={stats['crashed']} "
          f"makespan={stats['makespan_s']:.2f}s")
    by_dev = {}
    for uid, dev in sched.placements:
        by_dev.setdefault(dev, 0)
        by_dev[dev] += 1
    print("tasks per device:", by_dev)

    print("\n-- same jobs, SA baseline (one job per device) --")
    stats_sa = Executor(SAScheduler(num_devices=2), workers=2,
                        devices=[device]).run([j.ej for j in
                                               build_jobs(device)])
    speedup = stats_sa["makespan_s"] / stats["makespan_s"]
    print(f"completed={stats_sa['completed']} "
          f"makespan={stats_sa['makespan_s']:.2f}s "
          f"(MGB speedup {speedup:.2f}x on live {device_name(device)} execution)")

    print("\n-- fault tolerance: kill device 0 mid-run --")
    sched3 = MGBAlg3Scheduler(num_devices=2)
    jobs3 = build_jobs(device)
    ex3 = Executor(sched3, workers=4, devices=[device])
    evicted: List[Optional[int]] = [None]
    begun = threading.Event()
    for j in jobs3:
        j.ej.runners[0] = _signalling(j.ej.runners[0], begun)

    def killer():
        begun.wait()
        evicted[0] = len(sched3.mark_dead(0))
        print(f"  [failure injected] device 0 dead, {evicted[0]} task(s) "
              "evicted; survivors reschedule on device 1")
    kill = threading.Thread(target=killer)
    kill.start()
    try:
        stats3 = ex3.run([j.ej for j in jobs3])
    finally:
        begun.set()  # a run that raised before any runner frees the killer
        kill.join()
    print(f"completed={stats3['completed']} crashed={stats3['crashed']} "
          f"(all work landed on the surviving device)")
    assert stats3["completed"] + stats3["crashed"] == len(jobs3)

    print(f"\n-- decode fleet: {FLEET_REQUESTS} streamed decode requests, "
          "pool of 2, open arrival --")
    fl = fleet(device)
    print(f"completed={fl['done']}/{FLEET_REQUESTS} decode + background train "
          f"{fl['background']} in {fl['wall_s']:.2f}s "
          f"with 2 pool threads ({fl['stats']['sched_attempts']} admission "
          f"attempts; first request {fl['first']} record(s))")
    assert fl["done"] == FLEET_REQUESTS \
        and fl["stats"]["completed"] == FLEET_REQUESTS + 1
    print("\nshared_cluster OK")
    return {"jobs": probes, "mgb": stats, "per_device": by_dev,
            "sa": stats_sa, "speedup": speedup, "fault": stats3,
            "evicted": evicted[0], "fleet": fl}


if __name__ == "__main__":
    main()
