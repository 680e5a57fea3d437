"""Static serving: prefill + greedy decode under the compiler-guided
scheduler, on the card.

Port of ``src/repro/launch/serve.py:53-163, 252-266`` (static discipline).
Every request batch is ONE task whose resource vector comes from probing
the prefill (``repro_torch.core.probe``); each batch is submitted through
``Cluster`` with a per-request deadline (EDF within its priority class);
blocked batches park in the MGB scheduler's admission queue and completions
wake the next one. Rows of the last batch beyond ``requests`` are shape
padding: computed, never counted as served tokens.

Differences from the reference:

  * the scheduler's per-device memory is the card's
    (``torch.cuda.get_device_properties(i).total_memory``), not the 16 GB
    v5e default, under which a full gemma2-9b batch could never be placed;
  * decode runs over a cache padded to ``prompt_len + gen_len`` positions,
    as the continuous engine does (``src/repro/models/decode.py:210-233``).
    The reference hands the prompt-deep prefill cache to the decode loop,
    whose every step then overwrites the last prompt token's KV;
  * ``full=True`` serves the published configuration instead of
    ``.reduced()``, and ``param_dtype`` is passed through;
  * each runner synchronises its stream before it stamps a time, so TTFT
    and TPOT measure work, not launches.

Preemption, tracing and continuous batching come in later slices.

Usage (on a machine with an NVIDIA card):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --full --param-dtype bfloat16 --requests 32 --batch 4 \
        --prompt-len 1000 --gen-len 32
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob
from repro_torch.core.probe import probe_fn
from repro_torch.core.scheduler import MGBAlg3Scheduler
from repro_torch.core.scheduler.base import DEFAULT_HBM
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.models import decode as D
from repro_torch.models.model import DENSE_FAMILIES, init_params
from repro_torch.serve.decode import greedy_generate, make_prefill_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pct(xs, p):
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(int(p * (len(xs) - 1) + 0.5), len(xs) - 1)
    return xs[i]


def serving_devices(num_devices: int, device: Optional[str]):
    """(device table, per-device scheduler memory). CUDA unless ``device``
    is "cpu"; on CUDA one scheduler device per card, sized by the card."""
    if device == "cpu":
        return [torch.device("cpu")], DEFAULT_HBM
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to serve on the "
                           "CPU")
    if num_devices > torch.cuda.device_count():
        raise ValueError(f"num_devices={num_devices} but only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    devs = [torch.device("cuda", i) for i in range(num_devices)]
    hbm = min(torch.cuda.get_device_properties(d).total_memory for d in devs)
    return devs, hbm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def serve(arch: str, *, requests: int = 16, batch: int = 4,
          prompt_len: int = 64, gen_len: int = 32, seed: int = 0,
          num_devices: int = 1, workers: int = 0, deadline_s: float = 5.0,
          shed_late: bool = False, full: bool = False,
          param_dtype: torch.dtype = torch.float32,
          device: Optional[str] = None) -> dict:
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    devices, hbm = serving_devices(num_devices, device)
    # one copy of the weights per card, made from the seed on the card
    params = {}
    for dev in devices:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params[dev] = init_params(cfg, gen, param_dtype, dev)
    prefill = make_prefill_step(cfg)
    sched = MGBAlg3Scheduler(num_devices, hbm_per_device=hbm)

    rng = np.random.default_rng(seed)
    n_batches = (requests + batch - 1) // batch
    # real (non-padding) rows per batch
    rows = [min(batch, requests - i * batch) for i in range(n_batches)]

    def make_batch():
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (batch, prompt_len), dtype=np.int64))}
        if cfg.embedding_frontend_stub:
            b["embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, prompt_len, cfg.d_model), dtype=np.float32)
            ).to(param_dtype)
        return b

    batches = [make_batch() for _ in range(n_batches)]
    # probe ONE representative batch: all batches share shapes, so they
    # share the resource vector. Fake tensors only: nothing is allocated.
    first = devices[0]
    vec = probe_fn(prefill, params[first],
                   {k: v.to(first) for k, v in batches[0].items()})

    cluster = Cluster(sched, workers=workers or num_devices,
                      devices=devices, shed_late=shed_late)
    handles = []
    # per-batch wall-clock marks: (submit, first token, last token)
    marks = [[0.0, -1.0, -1.0] for _ in range(n_batches)]
    generated: List[Optional[np.ndarray]] = [None] * n_batches
    t0 = time.time()
    for i in range(n_batches):
        def runner(dev, i=i):
            p = params[dev]
            b = {k: v.to(dev) for k, v in batches[i].items()}
            logits, cache = prefill(p, b)
            if not bool(torch.isfinite(logits).all()):
                raise FloatingPointError(f"req{i}: non-finite prefill logits")
            first_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            _sync(dev)
            marks[i][1] = time.time()
            full_cache = D.cache_insert(
                D.init_cache(cfg, batch, prompt_len + gen_len, device=dev),
                cache, 0)
            del cache
            out, _ = greedy_generate(cfg, p, full_cache, first_tok,
                                     prompt_len, gen_len - 1)
            toks = torch.cat([first_tok[:, None], out], dim=1)
            generated[i] = toks[:rows[i]].cpu().numpy()  # synchronises
            marks[i][2] = time.time()

        marks[i][0] = time.time()
        task = Task(units=[UnitTask(fn=None, memobjs=frozenset({f"req{i}"}),
                                    resources=vec, name=f"req{i}")],
                    name=f"req{i}")
        handles.append(cluster.submit(
            ExecJob(job=Job(tasks=[task], name=f"req{i}"), runners=[runner]),
            deadline_s=deadline_s))

    cluster.drain()
    stats = cluster.stats()
    cluster.shutdown()
    wall = time.time() - t0
    done = [i for i, h in enumerate(handles) if h.status is JobStatus.DONE]
    toks = sum(rows[i] for i in done) * gen_len
    lat = [r.t_end - r.t_start
           for h in handles for r in h.records
           if not r.crashed and r.started]
    ttfts = [marks[i][1] - marks[i][0]
             for i in done for _ in range(rows[i]) if marks[i][1] >= 0]
    tpots = ([(marks[i][2] - marks[i][1]) / (gen_len - 1)
              for i in done for _ in range(rows[i]) if marks[i][2] >= 0]
             if gen_len > 1 else [])
    met = [h for h in handles if h.status is JobStatus.DONE
           and h.records and h.records[-1].t_end <= h.job.deadline_t]
    shed = [h for h in handles if h.status is JobStatus.SHED]
    return {"arch": cfg.name, "requests": requests, "batches": n_batches,
            "tokens_generated": toks, "wall_s": wall,
            "tokens_per_s": toks / wall,
            "mean_batch_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p50_ttft_s": _pct(ttfts, 0.50), "p99_ttft_s": _pct(ttfts, 0.99),
            "p50_tpot_s": _pct(tpots, 0.50), "p99_tpot_s": _pct(tpots, 0.99),
            "completed": stats["completed"], "crashed": stats["crashed"],
            "errors": [h.job.error for h in handles if h.job.error],
            "deadlines_met": len(met),
            "deadline_met_rate": len(met) / max(n_batches, 1),
            "shed": len(shed),
            "sched_attempts": stats["sched_attempts"],
            "placements": sched.placements,
            "probe": vec, "hbm_per_device": hbm,
            "generated": generated}


def main():
    dense = sorted(a for a, c in ARCHS.items()
                   if c.family in DENSE_FAMILIES and c.moe is None)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=dense)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--num-devices", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0,
                    help="execution-pool size (0 = one per device)")
    ap.add_argument("--deadline-s", type=float, default=5.0,
                    help="per-request admission deadline (EDF ordering)")
    ap.add_argument("--shed-late", action="store_true",
                    help="fail requests still parked past their deadline "
                         "(JobStatus.SHED) instead of serving them late")
    ap.add_argument("--full", action="store_true",
                    help="serve the published configuration, not .reduced()")
    ap.add_argument("--param-dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="run on the CPU (default: CUDA)")
    args = ap.parse_args()
    res = serve(args.arch, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                num_devices=args.num_devices, workers=args.workers,
                deadline_s=args.deadline_s, shed_late=args.shed_late,
                full=args.full, param_dtype=DTYPES[args.param_dtype],
                device=args.device)
    print(f"[serve] {res['arch']}: {res['completed']}/{res['batches']} "
          f"batches done, {res['crashed']} crashed, "
          f"{res['tokens_generated']} tokens in {res['wall_s']:.1f}s "
          f"({res['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50/p99 {res['p50_ttft_s'] * 1e3:.0f}/"
          f"{res['p99_ttft_s'] * 1e3:.0f} ms, "
          f"TPOT p50/p99 {res['p50_tpot_s'] * 1e3:.0f}/"
          f"{res['p99_tpot_s'] * 1e3:.0f} ms, "
          f"{res['deadlines_met']}/{res['batches']} deadlines met, "
          f"{res['shed']} shed, {res['sched_attempts']} admission attempts, "
          f"probe {res['probe'].hbm_bytes / 2**30:.2f} GiB/batch)")
    for err in res["errors"]:
        print(f"[serve] error: {err}")


if __name__ == "__main__":
    main()
