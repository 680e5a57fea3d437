"""Serving under the compiler-guided scheduler, on the card: static batches
(prefill + greedy decode) and continuous batching (``serve_continuous``).

Port of ``src/repro/launch/serve.py``.
Every request batch is ONE task whose resource vector comes from probing
what the task allocates (``static_task``: the prefill and its first
tokens, or on the card ``replayed_task``; ``repro_torch.core.probe``);
each batch is submitted through
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
    whose every step then overwrites the last prompt token's KV. A state
    cache (the ssm family) has no positions: decode runs on the prefill
    cache as it is, as in the reference;
  * ``full=True`` serves the published configuration instead of
    ``.reduced()``, and ``param_dtype`` is passed through;
  * ``n_layers`` cuts the depth of the configuration (every width stays
    the published one): mixtral-8x7b's 32 layers are 93.4e9 B in bf16 and
    exceed one 80 GB card, while 24 (70.2e9 B) leave room for the
    activations and the ring cache. Serving all 32 needs placement across
    cards, which the port does not have yet;
  * each runner synchronises its stream before it stamps a time, so TTFT
    and TPOT measure work, not launches;
  * each pool worker decodes its batches over buffers it keeps (a
    ``serve.decode.GreedyDecoder`` a worker: the padded cache, tokens,
    position and, on the card, the step captured once in a CUDA graph on
    the worker's stream and replayed for every later step of every
    batch), where the reference runs a jitted ``lax.scan`` over the
    prefill's cache. A batch's prefill cache is copied into them;
  * on the card the prefill is captured once per card and prompt shape
    (``serve.decode.PrefillGraph``, on a stream of its own) and replayed
    for every batch, the pool workers taking turns, where the reference
    runs one jitted prefill: its launches leave the interpreter, whose
    lock otherwise serialises the pool's eager prefills. The graph's pool
    holds the prefill's peak for the server's life, so what a batch
    allocates (``replayed_task``) shrinks by that much, and the card keeps
    it once (``kept_by_card``). On the CPU the prefill runs eagerly;
  * on a card the scheduler manages the memory free when serving starts,
    less what the pool keeps between tasks (``pool_reserve``: each
    worker's stream's cuBLAS workspace and, when serving statically, each
    worker's decoder, probed by ``kept_by_worker``, and the captured
    prefill, ``kept_by_card``), where the reference sizes it by the
    device.

With ``preempt=True`` (``--preempt``) the scheduler is the preemptive
Algorithm 3 (reference ``:57-64``): an arriving batch that strictly
outranks a resident one (a higher priority class, or an earlier deadline
within one) may evict it. The static runner is cooperative: it checks its
``ExecJob.preempted`` after the prefill and before each decode step (a
graph replay on the card; a host check, no synchronisation), and when
evicted it lets the steps in flight finish and returns, dropping what the
attempt made; its worker keeps its decoder, and the card the captured
prefill.
Serving has no checkpoint: the evicted batch is requeued and served again
from its prompt, and only the attempt that completes records tokens. The
result counts ``preemptions`` and ``migrations``.

``batch_job`` is one static batch as a task that brings its own weights:
its runner makes them from the seed on the device it is given, prefills,
decodes over a decoder of its own and frees all of it when it returns, and
its probe charges the weights, the prefill and the decoder. It is the unit
to submit beside other work on a shared card (an urgent batch that evicts a
training task there, ``chip_smoke.py``'s ``phase_preempt``).

``trace_path=`` (``--trace OUT_JSON``) records the scheduler's event
stream and writes it as a Chrome/Perfetto trace-event JSON at the end
(``Cluster.export_trace``), as the reference does.

It serves the dense attention, MoE, Mamba-1 (ssm) and zamba2 (hybrid)
families.

Usage (on a machine with an NVIDIA card):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --full --param-dtype bfloat16 --requests 32 --batch 4 \
        --prompt-len 1000 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --full --param-dtype bfloat16 --requests 32 \
        --batch 4 --prompt-len 1024 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --full --n-layers 24 --param-dtype bfloat16 --requests 32 \
        --batch 4 --prompt-len 1024 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --full --param-dtype bfloat16 --continuous --requests 32 \
        --batch 8 --prompt-len 1000 --gen-len 32 --workers 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob
from repro_torch.core.probe import (
    CUDA_UNSEEN_BYTES, TensorSpec, probe_fn,
)
from repro_torch.core.scheduler import (
    MGBAlg3Scheduler, PreemptiveAlg3Scheduler,
)
from repro_torch.core.scheduler.base import DEFAULT_HBM
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.models.model import FAMILIES, init_params
from repro_torch.serve.decode import (
    GreedyDecoder, PrefillGraph, decode_buffers, make_prefill_step,
)
from torch.utils._pytree import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pct(xs, p):
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(int(p * (len(xs) - 1) + 0.5), len(xs) - 1)
    return xs[i]


def serving_devices(num_devices: int, device: Optional[str]):
    """(device table, per-device memory). CUDA unless ``device`` is "cpu";
    on CUDA one scheduler device per card, sized by the memory free on the
    card when serving starts (the CUDA context and anything already
    allocated are not the scheduler's to hand out)."""
    if device == "cpu":
        return [torch.device("cpu")], DEFAULT_HBM
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to serve on the "
                           "CPU")
    if num_devices > torch.cuda.device_count():
        raise ValueError(f"num_devices={num_devices} but only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    devs = [torch.device("cuda", i) for i in range(num_devices)]
    hbm = min(torch.cuda.mem_get_info(d)[0] for d in devs)
    return devs, hbm


def pool_reserve(devices, workers: int,
                 kept: int = CUDA_UNSEEN_BYTES) -> int:
    """Bytes of each device that the execution pool holds outside every
    task, set aside from what the scheduler manages: on a card each pool
    worker keeps ``kept`` bytes for as long as the pool lives. Its stream
    keeps the cuBLAS workspace that its first task made (the probe's
    ``CUDA_UNSEEN_BYTES`` covers it while that task runs), the default;
    a static server's worker also keeps its decoder (``kept_by_worker``,
    whose probe includes the workspace once). What the workers share, a
    static server's captured prefill (``kept_by_card``), is set aside
    beside it."""
    return workers * kept if devices[0].type == "cuda" else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def static_task(params, batch: dict, cfg):
    """What one static serving task allocates, for its probe: the prefill
    and its first tokens. The task copies the prefill cache into its pool
    worker's decoder and decodes there (``GreedyDecoder``), allocating
    nothing more: the decoder is the worker's (``decode_state``)."""
    logits, cache = make_prefill_step(cfg)(params, batch)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def replayed_task(params, batch: dict, logits: torch.Tensor):
    """What one static serving task allocates when it replays the captured
    prefill (``PrefillGraph``), for its probe: its first tokens. The
    prefill's temporaries and outputs (``logits`` among them) live in the
    graph's pool, which the card keeps (``kept_by_card``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_state(params, first: torch.Tensor, cfg, max_seq: int):
    """What a static server's pool worker keeps between its tasks, for its
    probe: a ``GreedyDecoder``'s buffers for ``first.shape[0]`` rows and
    ``max_seq`` positions, and one decode step over them (on the card the
    step's temporaries live in the graph's memory pool for as long as the
    decoder does; a replay repeats them in place)."""
    cache = decode_buffers(cfg, first.shape[0], max_seq,
                           params["embed"].dtype, first.device)
    dec = GreedyDecoder(cfg, params, cache)
    dec.step()
    return dec.tokens


def kept_by_worker(params, first: torch.Tensor, cfg, max_seq: int):
    """The probe of what a static server's pool worker keeps: its decoder
    (``decode_state``: buffers, one step and, on a card, the cuBLAS
    workspace of the worker's stream), its weights uncharged."""
    return probe_fn(decode_state, params, first, cfg, max_seq,
                    uncharged=(0,))


def kept_by_card(params, batch: dict, cfg):
    """The probe of what a static server keeps on a card beside its
    workers' decoders: the captured prefill (``PrefillGraph``), whose pool
    holds the prefill's live peak and the graph's static copy of the
    batch, and whose stream keeps a cuBLAS workspace of its own (the
    probe's unseen bytes on a card): the prefill traced alone, its
    weights uncharged."""
    return probe_fn(static_task, params, batch, cfg, uncharged=(0,))


def owned_batch_task(params, batch: dict, cfg, max_seq: int):
    """What a ``batch_job`` task allocates, for its probe (with the weights
    charged: the task makes them): the prefill and its first tokens, then a
    decoder of its own loaded with the prefill's cache and one decode step
    over it (on the card the step's temporaries live in the graph's pool
    for the task's life)."""
    first, cache = static_task(params, batch, cfg)
    dec = GreedyDecoder(cfg, params, decode_buffers(
        cfg, first.shape[0], max_seq, params["embed"].dtype, first.device))
    dec.load(cache, first, batch["tokens"].shape[1])
    del cache
    dec.step()
    return dec.tokens


@dataclasses.dataclass
class BatchJob:
    """A ``batch_job``: ``ej`` to submit, its probe ``vec``, and what its
    runner records in ``result``: ``tokens`` ([rows, gen_len] int32 on the
    host, from the attempt that completed), the monotonic ``t_begin`` and
    ``t_first`` (first tokens synchronised) of each attempt, and
    ``attempts``."""
    ej: ExecJob
    vec: object
    result: Dict[str, object]


def batch_job(cfg, tokens: torch.Tensor, *, gen_len: int, seed: int = 0,
              param_dtype: torch.dtype = torch.bfloat16, device=None,
              name: str = "batch") -> BatchJob:
    """One static batch of prompts ``tokens`` [rows, prompt_len] as a task
    that brings its weights: the runner makes ``cfg``'s weights from
    ``seed`` on its device, prefills, decodes ``gen_len - 1`` greedy steps
    on a ``GreedyDecoder`` of its own (its step captured and replayed on
    the card) and frees all of it when it returns. It is cooperative: it
    checks ``ej.preempted`` after the prefill and before each step and
    returns early when evicted, recording no tokens. The probe
    (``owned_batch_task`` on specs of the weights, nothing allocated)
    charges the weights, the prefill and the decoder."""
    dev = torch.device(device) if device is not None \
        else serving_devices(1, None)[0][0]
    rows, prompt_len = tokens.shape
    max_seq = prompt_len + gen_len
    meta = init_params(cfg, None, param_dtype, torch.device("meta"))
    p_spec = tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype, dev),
                      meta)
    vec = probe_fn(owned_batch_task, p_spec, {"tokens": tokens.to(dev)},
                   cfg, max_seq)
    prefill = make_prefill_step(cfg)
    result: Dict[str, object] = {"tokens": None, "t_begin": [],
                                 "t_first": [], "attempts": 0}
    task = Task(units=[UnitTask(fn=None, memobjs=frozenset({name}),
                                resources=vec, name=name)], name=name)
    ej = ExecJob(job=Job(tasks=[task], name=name), runners=[])

    def runner(device) -> None:
        result["attempts"] += 1
        result["t_begin"].append(time.monotonic())
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, param_dtype, device)
        logits, cache = prefill(params, {"tokens": tokens.to(device)})
        if not bool(torch.isfinite(logits).all()):
            raise FloatingPointError(f"{name}: non-finite prefill logits")
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(device)
        result["t_first"].append(time.monotonic())
        del logits
        if ej.preempted.is_set():
            return
        dec = GreedyDecoder(cfg, params, decode_buffers(
            cfg, rows, max_seq, params["embed"].dtype, device))
        dec.load(cache, first, prompt_len)
        del cache
        out = dec.generate(gen_len - 1, stop=ej.preempted.is_set)
        if out is None:
            return
        toks = torch.cat([first[:, None], out], dim=1).cpu().numpy()
        if not ej.preempted.is_set():
            result["tokens"] = toks

    ej.runners.append(runner)
    return BatchJob(ej, vec, result)


def serve(arch: str, *, requests: int = 16, batch: int = 4,
          prompt_len: int = 64, gen_len: int = 32, seed: int = 0,
          num_devices: int = 1, workers: int = 0, deadline_s: float = 5.0,
          shed_late: bool = False, full: bool = False,
          param_dtype: torch.dtype = torch.float32,
          device: Optional[str] = None,
          n_layers: Optional[int] = None, preempt: bool = False,
          trace_path: Optional[str] = None) -> dict:
    """Serve ``requests`` prompts in static batches of ``batch``, each
    batch one task with its deadline (``deadline_s``), EDF within its
    class. With ``preempt`` the scheduler is the preemptive
    Algorithm 3 and the runners are cooperative (module docstring). With
    ``trace_path`` the run's trace is written there."""
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    published_layers = cfg.n_layers
    if n_layers is not None:
        if not 1 <= n_layers <= cfg.n_layers:
            raise ValueError(f"n_layers={n_layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    devices, hbm = serving_devices(num_devices, device)
    # one copy of the weights per card, made from the seed on the card
    params = {}
    for dev in devices:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params[dev] = init_params(cfg, gen, param_dtype, dev)
    prefill = make_prefill_step(cfg)
    workers = workers or num_devices
    max_seq = prompt_len + gen_len

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
    # probe ONE representative batch's task body: all batches share
    # shapes, so they share the resource vector; and what the pool keeps
    # between them. Fake tensors only: nothing is allocated.
    first = devices[0]
    batch0 = {k: v.to(first) for k, v in batches[0].items()}
    tokens0 = torch.zeros(batch, dtype=torch.int32, device=first)
    kept = kept_by_worker(params[first], tokens0, cfg, max_seq)
    shared = None
    if first.type == "cuda":  # prefills replayed from graphs
        vec = probe_fn(replayed_task, params[first], batch0,
                       TensorSpec((batch, cfg.vocab), torch.float32, first),
                       uncharged=(2,))
        shared = kept_by_card(params[first], batch0, cfg)
    else:
        vec = probe_fn(static_task, params[first], batch0, cfg)
    managed = hbm - pool_reserve(devices, workers, kept.hbm_bytes) \
        - (shared.hbm_bytes if shared else 0)
    sched = (PreemptiveAlg3Scheduler(num_devices, hbm_per_device=managed)
             if preempt else
             MGBAlg3Scheduler(num_devices, hbm_per_device=managed))
    # (pool thread, device) -> the decoder that thread keeps for it; on
    # the card (device, prompt shape) -> the captured prefill, which the
    # pool threads take turns to replay
    decoders, prefills = {}, {}
    capturing = threading.Lock()

    def prefilled(p, b, dev):
        """The prefill's (logits, cache) for batch ``b``, the caller's
        until the block ends."""
        if dev.type != "cuda":
            return contextlib.nullcontext(prefill(p, b))
        key = (dev, tuple(b["tokens"].shape))
        with capturing:
            graph = prefills.get(key)
            if graph is None:
                graph = prefills[key] = PrefillGraph(
                    prefill, p, b, torch.cuda.Stream(dev))
        return graph.replayed(b)

    cluster = Cluster(sched, workers=workers, devices=devices,
                      shed_late=shed_late, preempt=preempt or None,
                      trace=bool(trace_path))
    handles = []
    # per-batch wall-clock marks: (submit, first token, last token)
    marks = [[0.0, -1.0, -1.0] for _ in range(n_batches)]
    generated: List[Optional[np.ndarray]] = [None] * n_batches
    t0 = time.time()
    for i in range(n_batches):
        task = Task(units=[UnitTask(fn=None, memobjs=frozenset({f"req{i}"}),
                                    resources=vec, name=f"req{i}")],
                    name=f"req{i}")
        ej = ExecJob(job=Job(tasks=[task], name=f"req{i}"), runners=[])

        def runner(dev, i=i, ej=ej):
            p = params[dev]
            b = {k: v.to(dev) for k, v in batches[i].items()}
            key = (threading.get_ident(), dev)
            dec = decoders.get(key)
            if dec is None:
                dec = decoders[key] = GreedyDecoder(cfg, p, decode_buffers(
                    cfg, batch, max_seq, p["embed"].dtype, dev))
            with prefilled(p, b, dev) as (logits, cache):
                if not bool(torch.isfinite(logits).all()):
                    raise FloatingPointError(
                        f"req{i}: non-finite prefill logits")
                first_tok = torch.argmax(logits, dim=-1).to(torch.int32)
                # the decoder holds what decode reads
                dec.load(cache, first_tok, prompt_len)
                del logits, cache
            _sync(dev)
            marks[i][1] = time.time()
            if ej.preempted.is_set():
                return  # evicted: requeued and served again from its prompt
            out = dec.generate(gen_len - 1, stop=ej.preempted.is_set)
            if out is None:
                return
            toks = torch.cat([first_tok[:, None], out], dim=1)
            toks = toks[:rows[i]].cpu().numpy()  # synchronises
            if not ej.preempted.is_set():
                generated[i] = toks
                marks[i][2] = time.time()

        marks[i][0] = time.time()
        ej.runners.append(runner)
        handles.append(cluster.submit(ej, deadline_s=deadline_s))

    cluster.drain()
    stats = cluster.stats()
    cluster.shutdown()
    wall = time.time() - t0
    if trace_path:
        cluster.export_trace(trace_path)
    graphs = sum(d.graph is not None for d in decoders.values())
    prefill_graphs = len(prefills)
    decoders.clear()  # their buffers and graph pools go with them
    prefills.clear()
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
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "published_layers": published_layers,
            "requests": requests, "batches": n_batches,
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
            "preemptions": stats["preemptions"],
            "migrations": stats["migrations"],
            "sched_attempts": stats["sched_attempts"],
            "placements": sched.placements,
            "probe": vec, "kept_per_worker": kept, "kept_per_card": shared,
            "decode_graphs": graphs,
            "prefill_graphs": prefill_graphs,
            "hbm_per_device": sched.devices[0].total_hbm,
            "generated": generated}


def _track_peak_reservation(dev) -> List[int]:
    """[highest ``used_hbm``] of a scheduler device, kept up to date by
    wrapping this one device's ``admit`` (the only place a reservation
    grows)."""
    peak = [dev.used_hbm]
    admit = dev.admit

    def tracked(task) -> None:
        admit(task)
        peak[0] = max(peak[0], dev.used_hbm)

    dev.admit = tracked
    return peak


def serve_continuous(arch: str, *, requests: int = 16, batch: int = 4,
                     prompt_len: int = 64, gen_len: int = 32, seed: int = 0,
                     workers: int = 0, ttft_slo_s: float = 5.0,
                     tpot_slo_s: float = 1.0, shed_late: bool = False,
                     full: bool = False,
                     param_dtype: torch.dtype = torch.float32,
                     device: Optional[str] = None,
                     n_layers: Optional[int] = None,
                     trace_path: Optional[str] = None) -> dict:
    """Continuous-batching counterpart (reference
    ``src/repro/launch/serve.py:166-200``): per-request streaming through
    ``serve.engine.ServeEngine`` with a ``TorchModel``; ``batch`` becomes
    the decode loop's max rows. ``full``, ``n_layers``, ``param_dtype`` and
    ``device`` are the static path's. The engine's ``metrics()`` come back
    with ``wall_s``, ``tokens_per_s``, ``sched_attempts``, the highest
    ``used_hbm`` the scheduler reserved on the card during the run
    (``peak_reserved``), the loop base, slot and prefill vectors, and the
    tokens generated per request (``generated``, in submission order).
    With ``trace_path`` the run's trace is written there.

    One card: the model's weights live on one device (placement across
    cards comes in a later slice)."""
    from repro_torch.serve.engine import SLO, ServeEngine, TorchModel

    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    if n_layers is not None:
        if not 1 <= n_layers <= cfg.n_layers:
            raise ValueError(f"n_layers={n_layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    devices, hbm = serving_devices(1, device)
    gen = torch.Generator(device=devices[0]).manual_seed(seed)
    params = init_params(cfg, gen, param_dtype, devices[0])
    model = TorchModel(cfg, params, max_batch=batch,
                       max_seq=prompt_len + gen_len)
    workers = workers or 1
    sched = MGBAlg3Scheduler(
        1, hbm_per_device=hbm - pool_reserve(devices, workers))
    peak = _track_peak_reservation(sched.devices[0])
    cluster = Cluster(sched, workers=workers, devices=devices,
                      shed_late=shed_late, trace=bool(trace_path))
    eng = ServeEngine(cluster, model, max_batch=batch,
                      slo=SLO(ttft_s=ttft_slo_s, tpot_s=tpot_slo_s))
    rng = np.random.default_rng(seed)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, prompt_len),
                                             dtype=np.int64))
               for _ in range(requests)]
    t0 = time.time()
    reqs = [eng.submit(prompt=p, gen_len=gen_len) for p in prompts]
    eng.drain()
    wall = time.time() - t0
    m = eng.metrics()
    loop_vec = eng.loops[0].host.resources
    eng.shutdown()
    cluster.shutdown()
    if trace_path:
        cluster.export_trace(trace_path)
    m.update(arch=cfg.name, n_layers=cfg.n_layers, wall_s=wall,
             tokens_per_s=m["tokens"] / wall,
             sched_attempts=cluster.stats()["sched_attempts"],
             peak_reserved=peak[0],
             hbm_per_device=sched.devices[0].total_hbm,
             loop_vec=loop_vec, slot_vec=model.slot_vec(reqs[0]),
             prefill_vec=model.prefill_vec(reqs[0]),
             capture_s=model.capture_s, steps=model.steps,
             step_s=model.step_s,
             errors=[r.error for r in reqs if r.error],
             generated=[list(r.tokens) for r in reqs])
    return m


def main():
    served = sorted(a for a, c in ARCHS.items() if c.family in FAMILIES)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=served)
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
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (every width "
                         "stays; mixtral-8x7b needs 24 to fit one 80 GB "
                         "card)")
    ap.add_argument("--param-dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="run on the CPU (default: CUDA)")
    ap.add_argument("--preempt", action="store_true",
                    help="preemptive EDF: an arriving request batch that "
                         "outranks a resident one may evict it (it is "
                         "served again from its prompt) instead of "
                         "queueing behind it (static mode only)")
    ap.add_argument("--tpot-slo-s", type=float, default=1.0,
                    help="continuous mode: time-per-output-token SLO")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record the scheduler's event stream and write a "
                         "Chrome/Perfetto trace-event JSON here at the end "
                         "(load in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching via repro_torch.serve.engine: "
                         "requests stream individually, the decode batch "
                         "grows/shrinks per step under scheduler admission "
                         "(--batch is the loop's max rows, --deadline-s the "
                         "TTFT SLO)")
    args = ap.parse_args()
    if args.continuous:
        if args.num_devices != 1:
            ap.error("--continuous serves on one device (--num-devices 1)")
        if args.preempt:
            ap.error("--preempt is for static serving")
        res = serve_continuous(
            args.arch, requests=args.requests, batch=args.batch,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            workers=args.workers,
            ttft_slo_s=args.deadline_s, tpot_slo_s=args.tpot_slo_s,
            shed_late=args.shed_late, full=args.full,
            param_dtype=DTYPES[args.param_dtype], device=args.device,
            n_layers=args.n_layers, trace_path=args.trace)
        print(f"[serve --continuous] {res['arch']} ({res['n_layers']} "
              f"layers): {res['done']}/{res['requests']} done, "
              f"{res['tokens']} tokens in {res['wall_s']:.1f}s "
              f"({res['tokens_per_s']:.1f} tok/s, "
              f"TTFT p50/p99 {res['p50_ttft_s'] * 1e3:.0f}/"
              f"{res['p99_ttft_s'] * 1e3:.0f} ms, "
              f"TPOT p50/p99 {res['p50_tpot_s'] * 1e3:.0f}/"
              f"{res['p99_tpot_s'] * 1e3:.0f} ms, "
              f"goodput {res['goodput_rps']:.2f} req/s, "
              f"{res['shed']} shed, {res['failed']} failed, "
              f"{res['violations']} memory violations)")
        for err in res["errors"]:
            print(f"[serve --continuous] error: {err}")
        return
    res = serve(args.arch, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                num_devices=args.num_devices, workers=args.workers,
                deadline_s=args.deadline_s, shed_late=args.shed_late,
                full=args.full, param_dtype=DTYPES[args.param_dtype],
                device=args.device, n_layers=args.n_layers,
                preempt=args.preempt, trace_path=args.trace)
    print(f"[serve] {res['arch']} ({res['n_layers']} of "
          f"{res['published_layers']} layers): {res['completed']}/"
          f"{res['batches']} "
          f"batches done, {res['crashed']} crashed, "
          f"{res['tokens_generated']} tokens in {res['wall_s']:.1f}s "
          f"({res['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50/p99 {res['p50_ttft_s'] * 1e3:.0f}/"
          f"{res['p99_ttft_s'] * 1e3:.0f} ms, "
          f"TPOT p50/p99 {res['p50_tpot_s'] * 1e3:.0f}/"
          f"{res['p99_tpot_s'] * 1e3:.0f} ms, "
          f"{res['deadlines_met']}/{res['batches']} deadlines met, "
          f"{res['shed']} shed, {res['preemptions']} preemption(s), "
          f"{res['migrations']} migration(s), "
          f"{res['sched_attempts']} admission attempts, "
          f"probe {res['probe'].hbm_bytes / 2**30:.2f} GiB/batch)")
    for err in res["errors"]:
        print(f"[serve] error: {err}")


if __name__ == "__main__":
    main()
