"""End-to-end training launcher under the compiler-guided scheduler: the whole
run is ONE task whose resource vector is the probe of one train step over
the run's state, admitted by MGB onto the card and executed there (data
pipeline -> train loop with checkpointing).

Port of ``src/repro/launch/train.py``. Differences from the reference:

  * the mesh arguments are gone: the port trains on one device
    (distribution is ROADMAP item 8), and with them the straggler
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
    events, on a card) and tokens/s.

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
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob
from repro_torch.core.probe import probe_fn
from repro_torch.core.scheduler import MGBAlg3Scheduler
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.data.pipeline import Prefetcher, TokenPipeline, to_device
from repro_torch.launch.serve import pool_reserve, serving_devices
from repro_torch.launch.specs import input_specs
from repro_torch.models.model import ATTN_IMPLS, init_params
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as CK
from repro_torch.train.train_step import abstract_train_state, make_train_step


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, n_layers: Optional[int] = None,
          device: Optional[str] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, resume: bool = False, seed: int = 0,
          attn_impl: str = "flash_kernel", lr: float = 3e-4,
          log_every: int = 10) -> dict:
    """Train ``arch`` for ``steps`` steps as one scheduled task. Returns the
    per-step metrics (``losses``, ``grad_norms``, ``lrs``, ``step_ms``,
    ``device_ms``, ``tokens_per_s``), the task's ``probe`` vector, how it
    ended (``status``, ``error``), ``reduced`` (the cuts of the published
    configuration), ``peak_allocated`` (a card's
    ``max_memory_allocated`` after the run, 0 on the CPU)."""
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
    devices, hbm = serving_devices(1, device)
    dev = devices[0]
    shape = ShapeConfig("train", seq, batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                                total_steps=steps,
                                moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(cfg, opt_cfg, attn_impl=attn_impl)

    # the task: one step over the run's state, probed on specs
    p_spec, o_spec = abstract_train_state(cfg, opt_cfg, torch.float32, dev)
    vec = probe_fn(step_fn, p_spec, o_spec, input_specs(cfg, shape, dev))
    sched = MGBAlg3Scheduler(1, hbm_per_device=hbm - pool_reserve(devices, 1))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "reduced": cuts,
           "probe": vec, "losses": [], "grad_norms": [], "lrs": [],
           "step_ms": [], "device_ms": [], "tokens_per_s": [],
           "start_step": 0}

    def runner(device) -> None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, torch.float32, device)
        opt_state = adamw.init_state(opt_cfg, params)
        start = 0
        ckpt = CK.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        if resume and ckpt_dir and CK.latest_step(ckpt_dir) is not None:
            start, state = CK.restore(ckpt_dir,
                                      {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start}", flush=True)
        out["start_step"] = start
        pipe = TokenPipeline(cfg, shape, seed=seed, start_step=start,
                             batch_override=batch, seq_override=seq)
        prefetch = Prefetcher(pipe)
        on_card = device.type == "cuda"
        try:
            for step in range(start, steps):
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
                if ckpt and (step + 1) % ckpt_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if ckpt:
                ckpt.save(steps, {"params": params, "opt": opt_state})
                ckpt.wait()
        finally:
            prefetch.close()
        if on_card:
            torch.cuda.current_stream(device).synchronize()

    task = Task(units=[UnitTask(fn=None, memobjs=frozenset({"train"}),
                                resources=vec, name="train")], name="train")
    cluster = Cluster(sched, workers=1, devices=devices)
    t0 = time.time()
    handle = cluster.submit(ExecJob(job=Job(tasks=[task], name="train"),
                                    runners=[runner]))
    cluster.drain()
    cluster.shutdown()
    out.update(wall_s=time.time() - t0, status=handle.status.value,
               error=handle.job.error,
               steps=len(out["losses"]),
               final_loss=out["losses"][-1] if out["losses"] else None,
               peak_allocated=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else 0)
    if handle.status is not JobStatus.DONE:
        raise RuntimeError(f"train {cfg.name}: the task ended "
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
