"""End-to-end training launcher under the compiler-guided scheduler: the whole
run is ONE task whose resource vector is the probe of one train step over
the run's state, admitted by MGB onto the card and executed there (data
pipeline -> train loop with checkpointing).

Port of ``src/repro/launch/train.py``. Differences from the reference:

  * the mesh arguments are gone: the port trains on one device
    (distribution is ROADMAP A, "Distribution"), and with them the straggler
    detector, which compares hosts (``train/straggler.py`` waits for it);
  * the run goes through the paper's loop on every call: ``probe_fn`` of
    one step on ``TensorSpec``s of the state and the batch (nothing
    allocated) -> ``Cluster`` with MGB admission -> executor, whose runner
    makes the state on the device it is given and trains there; the
    scheduler manages the memory free on the card when training starts;
  * ``reduced=False`` (``--full``) trains the published configuration
    and ``n_layers`` cuts its depth (every width stays the published one), as
    ``launch/serve.py`` does; each cut is reported under ``reduced``.
    gemma2-9b's 42 layers in f32 with two f32 moments and a gradient are
    9.24e9 parameters x 16 B = 148e9 B, beyond one 80 GB card;
  * parameters are f32, as the reference's ``init_params`` makes them;
    each step reports loss, grad norm, lr, host ms, device ms (CUDA
    events, on a card) and tokens/s;
  * the run is a preemptible task, the design the reference's ``ExecJob``
    describes (``src/repro/core/executor.py:96-108``) but its trainer never
    wires: ``train`` takes a ``priority``, a ``deadline_s`` and a
    ``scheduler`` (a preemptive one lets an urgent task evict it), and the
    runner checks ``ExecJob.preempted`` at each step boundary, saves the
    last finished step and returns; the re-dispatched attempt resumes from
    the step its run saved last (``train_job``). ``ExecJob.on_preempt`` only
    records when the notice came: it fires on the scheduler's notify
    thread, beside the runner, and must not touch its tensors.

The loop runs on CUDA unless ``device="cpu"``; with no card and no CPU
request it raises.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --full --n-layers 12 --batch 4 --seq 1024 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob
from repro_torch.core.probe import probe_fn
from repro_torch.core.scheduler import MGBAlg3Scheduler
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.data.pipeline import Prefetcher, TokenPipeline, to_device
from repro_torch.launch.serve import pool_reserve, serving_devices
from repro_torch.launch.specs import input_specs
from repro_torch.models.model import ATTN_IMPLS, init_params
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as CK
from repro_torch.train.train_step import abstract_train_state, make_train_step


@dataclasses.dataclass
class TrainRun:
    """One training run as a preemptible task (``train_job``): ``ej`` to
    submit, ``out`` the per-step metrics the runner fills (see ``train``),
    ``cfg`` and ``vec`` (the probe of one step). ``attempts`` has one dict
    per attempt of the runner: ``start`` (the step it began from),
    ``restore_s`` (when it resumed from a checkpoint), and when evicted
    ``evicted_at`` (the step it saved), ``copy_s`` (the state's copy to the
    host), ``nbytes`` and ``t_exit``; ``notices`` the monotonic times of
    the eviction notices (``ExecJob.on_preempt``, bookkeeping only)."""
    ej: ExecJob
    out: dict
    cfg: object
    vec: object
    ckpt: Optional[CK.AsyncCheckpointer]
    attempts: List[dict] = dataclasses.field(default_factory=list)
    notices: List[float] = dataclasses.field(default_factory=list)
    tmp_dir: Optional[str] = None

    def close(self) -> None:
        """Wait for a write in flight and remove a temporary checkpoint
        directory (the one an eviction without ``ckpt_dir`` made)."""
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.tmp_dir is not None:
            shutil.rmtree(self.tmp_dir, ignore_errors=True)
            self.tmp_dir = None

    def result(self, status, error, wall_s: float) -> dict:
        """``out`` completed with how the task ended."""
        out = self.out
        out.update(wall_s=wall_s, status=status.value, error=error,
                   steps=len(out["losses"]),
                   final_loss=out["losses"][-1] if out["losses"] else None,
                   attempts=self.attempts, notices=self.notices)
        if self.ckpt is not None:
            out["checkpoint"] = {"nbytes": self.ckpt.nbytes,
                                 "copy_s": self.ckpt.copy_s,
                                 "write_s": self.ckpt.write_s}
        return out


def train_job(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
              reduced: bool = True, n_layers: Optional[int] = None,
              device=None, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 20, resume: bool = False, seed: int = 0,
              attn_impl: str = "flash_kernel", lr: float = 3e-4,
              log_every: int = 10,
              on_step: Optional[Callable[[int], None]] = None,
              keep_state: bool = False) -> TrainRun:
    """The training run as one task, not yet submitted: its probe (one step
    on ``TensorSpec``s of the state on ``device``, nothing allocated) and
    its runner, which makes the state on the device it is given and trains
    there. ``on_step(k)`` is called on the runner's thread after step k
    (counted from 1) has finished. With ``keep_state`` the final parameters
    and optimizer state are kept, copied to the host, in ``out["params"]``
    and ``out["opt_state"]``.

    The runner is cooperative: at each step boundary it checks
    ``ej.preempted``. When evicted, it saves the last finished step through
    an ``AsyncCheckpointer`` (the state's copy to the host; the write held
    back) and returns, dropping its tensors (the executor returns their
    blocks to the card). The re-dispatched attempt restores the step its
    run saved last from the checkpointer's host copy, in place of a fresh
    state, so it resumes at the step the eviction saved, never at a step
    another run left in ``ckpt_dir``; then it commits the held write, which
    runs beside its steps (ROADMAP C15). ``resume`` restores the newest
    committed step in ``ckpt_dir`` on the first attempt. Without
    ``ckpt_dir`` an evicted run checkpoints under a temporary directory
    (``TMPDIR``), which ``TrainRun.close`` removes. With ``ckpt_dir`` on a
    card, the first attempt pins the host mirror its checkpoints copy into
    while its first steps run (``AsyncCheckpointer.reserve``), so an
    eviction only copies."""
    cfg = get_arch(arch)
    cuts: List[str] = []
    if reduced:
        cfg = cfg.reduced()
        cuts.append("reduced() widths")
    if n_layers is not None:
        if not 1 <= n_layers <= cfg.n_layers:
            raise ValueError(f"n_layers={n_layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        if n_layers != cfg.n_layers:
            cuts.append(f"depth {cfg.n_layers} -> {n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device) if device is not None \
        else serving_devices(1, None)[0][0]
    shape = ShapeConfig("train", seq, batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                                total_steps=steps,
                                moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(cfg, opt_cfg, attn_impl=attn_impl)

    # the task: one step over the run's state, probed on specs
    p_spec, o_spec = abstract_train_state(cfg, opt_cfg, torch.float32,
                                          dev)
    vec = probe_fn(step_fn, p_spec, o_spec, input_specs(cfg, shape, dev))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "reduced": cuts,
           "probe": vec, "losses": [], "grad_norms": [], "lrs": [],
           "step_ms": [], "device_ms": [], "tokens_per_s": [],
           "start_step": 0}
    ckpt = CK.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    task = Task(units=[UnitTask(fn=None, memobjs=frozenset({"train"}),
                                resources=vec, name="train")], name="train")
    run = TrainRun(ExecJob(job=Job(tasks=[task], name="train"), runners=[]),
                   out, cfg, vec, ckpt)
    run.ej.on_preempt = lambda t: run.notices.append(time.monotonic())

    def runner(device) -> None:
        attempt = {"start": 0}
        run.attempts.append(attempt)
        # a re-dispatched attempt takes the step its run saved last, from
        # the host copy; a first one with ``resume`` the newest on disk
        saved = (run.ckpt is not None and run.ckpt.saved_step is not None
                 and len(run.attempts) > 1)
        if saved or (len(run.attempts) == 1 and resume and ckpt_dir
                     and CK.latest_step(ckpt_dir) is not None):
            t0 = time.perf_counter()
            # the state's storage, filled from the checkpoint in place
            params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                    device=device), p_spec)
            state = {"params": params,
                     "opt": adamw.init_state(opt_cfg, params)}
            start, state = (run.ckpt.restore_into(state) if saved
                            else CK.restore_into(ckpt_dir, state))
            params, opt_state = state["params"], state["opt"]
            attempt["restore_s"] = time.perf_counter() - t0
            if saved:
                run.ckpt.commit()  # the write an eviction held back
            print(f"[train] resumed from step {start}", flush=True)
        else:
            start = 0
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, gen, torch.float32, device)
            opt_state = adamw.init_state(opt_cfg, params)
        attempt["start"] = start
        if len(run.attempts) == 1:
            out["start_step"] = start
        pipe = TokenPipeline(cfg, shape, seed=seed, start_step=start,
                             batch_override=batch, seq_override=seq)
        prefetch = Prefetcher(pipe)
        on_card = device.type == "cuda"
        if on_card and run.ckpt is not None and len(run.attempts) == 1:
            # the host mirror an eviction copies into, pinned while the
            # first steps run
            run.ckpt.reserve({"params": p_spec, "opt": o_spec})
        try:
            for step in range(start, steps):
                if run.ej.preempted.is_set():
                    # evicted: copy the last finished step to the host and
                    # return; the write is left to the attempt that resumes
                    # (one in flight would stall the release of the card's
                    # blocks and slow the preemptor)
                    if run.ckpt is None:
                        run.tmp_dir = tempfile.mkdtemp(
                            prefix="repro_torch_train_")
                        run.ckpt = CK.AsyncCheckpointer(run.tmp_dir, keep=1)
                    run.ckpt.save(step, {"params": params,
                                         "opt": opt_state}, start=False)
                    attempt.update(evicted_at=step,
                                   copy_s=run.ckpt.copy_s,
                                   nbytes=run.ckpt.nbytes)
                    print(f"[train] evicted at step {step}: "
                          f"{run.ckpt.nbytes} B copied to the host in "
                          f"{run.ckpt.copy_s * 1e3:.1f} ms", flush=True)
                    return
                b = to_device(next(prefetch), device)
                if on_card:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, b)
                if on_card:
                    ev[1].record()
                loss = float(metrics["loss"])  # waits for the step
                host_s = time.perf_counter() - t0
                dev_ms = ev[0].elapsed_time(ev[1]) if on_card else None
                for col, val in (("losses", loss),
                                 ("grad_norms", float(metrics["grad_norm"])),
                                 ("lrs", float(metrics["lr"])),
                                 ("step_ms", host_s * 1e3),
                                 ("device_ms", dev_ms),
                                 ("tokens_per_s", batch * seq / host_s)):
                    out[col].append(val)
                if step % log_every == 0 or step == steps - 1:
                    dms = f", device {dev_ms:.1f} ms" if on_card else ""
                    print(f"[train] step {step:5d} loss {loss:.4f} gnorm "
                          f"{out['grad_norms'][-1]:.3f} lr "
                          f"{out['lrs'][-1]:.2e} {host_s * 1e3:.1f} ms{dms}, "
                          f"{batch * seq / host_s:.0f} tok/s", flush=True)
                if ckpt_dir and (step + 1) % ckpt_every == 0:
                    run.ckpt.save(step + 1, {"params": params,
                                             "opt": opt_state})
                if on_step is not None:
                    on_step(step + 1)
            if ckpt_dir:
                run.ckpt.save(steps, {"params": params, "opt": opt_state})
                run.ckpt.wait()
            if keep_state:
                out["params"], out["opt_state"] = tree_map(
                    lambda x: x.to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x,
                    (params, opt_state))
        finally:
            prefetch.close()
            attempt["t_exit"] = time.monotonic()
        if on_card:
            torch.cuda.current_stream(device).synchronize()

    run.ej.runners.append(runner)
    return run


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, n_layers: Optional[int] = None,
          device: Optional[str] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, resume: bool = False, seed: int = 0,
          attn_impl: str = "flash_kernel", lr: float = 3e-4,
          log_every: int = 10, priority: int = 0,
          deadline_s: Optional[float] = None,
          scheduler: Optional[Scheduler] = None,
          keep_state: bool = False) -> dict:
    """Train ``arch`` for ``steps`` steps as one scheduled task
    (``train_job``) at ``priority`` with ``deadline_s``, under
    ``scheduler`` (default: MGB Algorithm 3 over the memory free on the
    card when training starts, less the pool's reserve). Returns the
    per-step metrics (``losses``, ``grad_norms``, ``lrs``, ``step_ms``,
    ``device_ms``, ``tokens_per_s``), the task's ``probe`` vector, how it
    ended (``status``, ``error``), ``reduced`` (the cuts of the published
    configuration), ``attempts`` (one entry per attempt: an evicted one
    says where it saved), ``peak_allocated`` (a card's
    ``max_memory_allocated`` after the run, 0 on the CPU) and, with
    ``keep_state``, the final ``params`` and ``opt_state`` on the host."""
    devices, hbm = serving_devices(1, device)
    dev = devices[0]
    run = train_job(arch, steps=steps, batch=batch, seq=seq,
                    reduced=reduced, n_layers=n_layers, device=dev,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
                    seed=seed, attn_impl=attn_impl, lr=lr,
                    log_every=log_every, keep_state=keep_state)
    if scheduler is None:
        scheduler = MGBAlg3Scheduler(
            1, hbm_per_device=hbm - pool_reserve(devices, 1))
    cluster = Cluster(scheduler, workers=1, devices=devices)
    t0 = time.time()
    handle = cluster.submit(run.ej, priority=priority,
                            deadline_s=deadline_s)
    cluster.drain()
    cluster.shutdown()
    run.close()
    out = run.result(handle.status, handle.job.error, time.time() - t0)
    out["peak_allocated"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    if handle.status is not JobStatus.DONE:
        raise RuntimeError(f"train {run.cfg.name}: the task ended "
                           f"{handle.status.value}: {handle.job.error}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced())")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="train on the CPU (default: CUDA)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--attn-impl", default="flash_kernel",
                    choices=list(ATTN_IMPLS))
    args = ap.parse_args()
    res = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=not args.full, n_layers=args.n_layers,
                device=args.device, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                seed=args.seed, attn_impl=args.attn_impl, lr=args.lr,
                log_every=1)
    vec = res["probe"]
    print(f"[train] {res['arch']}, {res['n_layers']} layers; reduced: "
          f"{', '.join(res['reduced']) or 'nothing'}; probe hbm "
          f"{vec.hbm_bytes} B, {vec.flops:.4e} flops a step")
    print(f"[train] done: {res['steps']} steps, final_loss="
          f"{res['final_loss']:.4f} wall={res['wall_s']:.1f}s "
          f"({res['steps'] / res['wall_s']:.2f} steps/s)")


if __name__ == "__main__":
    main()
