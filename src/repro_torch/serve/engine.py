"""Continuous-batching decode serving under the memory-safe scheduler.

The sglang/LightLLM-style front-end over this repo's compiler-guided
fleet: per-device decode loops whose batch composition changes BETWEEN
steps. Requests stream in through ``Cluster.submit`` with SLO deadlines and
split into two task classes:

  * **prefill** — a short, high-priority task (class ``prefill_priority``)
    that ingests the prompt and produces the first token + a batch-1 KV
    cache. It runs through the normal backend (live: real jitted compute on
    the execution pool; sim: virtual-time work) with a TTFT deadline.
  * **decode slot** — a long-lived RESIDENT delta: joining a running batch
    is ``Scheduler.task_grow`` with a probed ResourceVector whose
    ``hbm_bytes`` are the slot's KV-cache footprint (``abstract_cache``, not
    a guess) and whose compute share encodes one batch row. A join that
    would OOM the device — or exceed the loop's row budget — PARKS in the
    same admission queue as everything else and is admitted by the
    ``task_end``/``task_shrink`` freed-capacity drain when a row retires.
    The scheduler's memory-hard guarantee therefore covers batch GROWTH,
    not just task admission.

Each decode loop itself is one long-lived resident task
(``Scheduler.bind_resident``) carrying ``slot_budget = max_batch``: the
scheduler's grow admission — not engine bookkeeping — is what bounds a loop
to ``max_batch`` concurrent rows (`Task.grown_now` vs the budget, settled on
every release path including eviction).

Per-request metrics: TTFT (arrival → first token, i.e. prefill completion)
and TPOT (mean inter-token time over the decode tail), the two serving SLOs
``benchmarks/bench_serve.py`` drives to saturation.

The engine is driven explicitly: ``pump()`` advances every decode loop one
step (live mode — call it in a loop; also what the deterministic live/sim
parity tests use), and ``run_until(t)`` advances a sim-backend cluster's
virtual clock with decode ticks interleaved at the model's step cadence.

Port of ``src/repro/serve/engine.py``: ``SLO``, ``RequestStatus``,
``ServeRequest``, ``NullModel``, ``_Loop`` and ``ServeEngine`` are copies
with their imports rewritten to ``repro_torch`` (keep them in step);
``JaxModel`` becomes ``TorchModel``, whose decode step is replayed from a
CUDA graph on the card where the reference jits it, and whose rows are
allocated with the loop, so its joins carry no memory delta (the base
holds every row; see its docstring). ``run_until`` and the sim branch of
``drain`` drive the port's ``Cluster(backend="sim")``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cluster import Cluster, JobHandle, JobStatus
from repro_torch.core.probe import probe_fn
from repro_torch.core.scheduler.base import DEADLINE_SHED, SLOTS, Scheduler
from repro_torch.core.task import Job, ResourceVector, Task, UnitTask
from repro_torch.models import decode as D
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.decode import (
    StepGraph, capture_stream, make_prefill_step, resident_ring,
)

_rids = itertools.count()


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service objectives: time-to-first-token and
    time-per-output-token (both seconds)."""
    ttft_s: float = 2.0
    tpot_s: float = 0.2


class RequestStatus(enum.Enum):
    PREFILLING = "prefilling"      # prefill task submitted / running
    WAITING_SLOT = "waiting_slot"  # prefilled; decode-slot join parked
    DECODING = "decoding"          # resident row in a decode loop
    DONE = "done"
    SHED = "shed"                  # deadline shed (prefill or join)
    FAILED = "failed"              # crashed / fleet cannot host it


@dataclasses.dataclass
class ServeRequest:
    """One streaming generation request and its lifecycle timestamps."""
    rid: int
    prompt_len: int
    gen_len: int                   # TOTAL tokens incl. the prefill's first
    arrival_t: float
    status: RequestStatus = RequestStatus.PREFILLING
    tokens: List[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0
    t_first: float = -1.0          # first token emitted (prefill done)
    t_done: float = -1.0
    error: str = ""
    # internals
    prompt: Any = None             # [1, S] tokens (real model) or None
    cache: Any = None              # batch-1 prefill cache (real model)
    first_token: Optional[int] = None
    slot_task: Optional[Task] = None
    join_epoch: int = 0
    device: Optional[int] = None
    row: Optional[int] = None

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.arrival_t if self.t_first >= 0 else -1.0

    @property
    def tpot_s(self) -> float:
        """Mean inter-token time over the decode tail (0 for 1-token
        requests — there is no tail)."""
        if self.t_done < 0 or self.t_first < 0 or self.n_tokens <= 1:
            return 0.0
        return (self.t_done - self.t_first) / (self.n_tokens - 1)


# ---------------------------------------------------------------------------
# Model backends
# ---------------------------------------------------------------------------

class NullModel:
    """No-compute model backend: synthetic resource vectors and token
    counting only. The scheduler-facing shape is identical to the real
    backend (probed-shaped loop/slot/prefill vectors), so benches and
    live/sim parity tests exercise the full admission machinery without
    paying for kernels."""

    def __init__(self, *, loop_hbm: int = 2 << 30, slot_hbm: int = 1 << 30,
                 prefill_hbm: int = 1 << 30, prefill_s: float = 0.05,
                 step_s: float = 0.025):
        self.loop_hbm = loop_hbm
        self.slot_hbm = slot_hbm
        self.prefill_hbm = prefill_hbm
        self.prefill_s = prefill_s
        self.step_seconds = step_s

    def loop_vec(self, max_batch: int) -> ResourceVector:
        # compute share of the loop base; rows carry 1/SLOTS each. The row
        # CAP is the host task's slot_budget (set by ServeEngine), not this.
        d = (SLOTS - max_batch) / SLOTS
        return ResourceVector(hbm_bytes=self.loop_hbm, flops=0.0,
                              bytes_accessed=0.0, core_demand=d, bw_demand=d)

    def slot_vec(self, req: ServeRequest) -> ResourceVector:
        return ResourceVector(hbm_bytes=self.slot_hbm, flops=0.0,
                              bytes_accessed=0.0, est_seconds=self.step_seconds,
                              core_demand=1 / SLOTS, bw_demand=1 / SLOTS)

    def prefill_vec(self, req: ServeRequest) -> ResourceVector:
        return ResourceVector(hbm_bytes=self.prefill_hbm, flops=0.0,
                              bytes_accessed=0.0, est_seconds=self.prefill_s,
                              core_demand=2 / SLOTS, bw_demand=2 / SLOTS)

    def prefill(self, req: ServeRequest) -> None:
        req.first_token = 0

    def make_loop_state(self, rows: int) -> Any:
        return None

    def adopt(self, state: Any, row: int, req: ServeRequest) -> None:
        pass

    def step(self, state: Any, rows: List[Optional[ServeRequest]]) -> None:
        pass


class TorchModel:
    """Real-model backend in PyTorch (the reference's ``JaxModel``):
    prefill on a pool worker, then per device one resident decode loop over
    a static ``[max_batch]`` cache (``models.decode`` slot-wise insert),
    every row at its own position.

    Per device (``make_loop_state``) it holds the cache (``loop_cache``)
    and device buffers of tokens, positions and a 0/1 mask of the rows in
    use, all zero at first as the reference's numpy buffers are. On the
    card the loop's step (``loop_step``: decode, argmax, token
    write-back, ``pos += 1`` for the rows in use) is captured in a CUDA
    graph (``serve.decode.StepGraph``) after one eager warm-up on the loop's
    own stream; ``step`` replays it and copies the ``[B]`` next tokens to the
    host, and ``adopt`` writes a prefilled row into the static buffers in
    place, so the graph stays valid. On the CPU the step runs eagerly. Rows
    not in use compute but keep their token and position, as the reference
    leaves them.

    Resource vectors, each a departure from the reference where it says so:

      * ``loop_vec``: the probed footprint of a full loop (the weights,
        counted once, the whole ``[max_batch]`` cache and buffers, one
        step's temporaries, which the graph's memory pool holds) plus one
        row's cache bytes for adoption, whose copy into a row reaches the
        card through a temporary of at most that size (rows are adopted
        one at a time). The reference charges the loop without the rows'
        share; the port allocates every row with the loop, since a
        captured graph's buffers cannot grow, so the base holds them all;
      * ``slot_vec``: a row's compute share and a zero memory delta (its
        cache is already in the base), so a join is bounded by the loop's
        row budget, not by memory. The reference charges one row's cache
        bytes (``slot_bytes`` here) per join;
      * ``prefill_vec``: the batch-1 prefill, with the weights traced but
        NOT charged. The reference's prefill probe counts them as
        arguments (``engine.py:217-219``): the loop base already holds
        them, and a second charge per prefill would keep every prefill of
        mixtral-8x7b (70.19e9 B of weights at 24 layers, on an 85e9 B
        card) out for good.

    A prefilled request's cache waits for its row on the host (pinned
    memory on the card's host): the scheduler charges it to the prefill
    while the prefill runs and to the row once the row joins, and to
    nothing in between, so it may not stay on the card (the reference keeps
    it there). A ring prefill cache is first cut to the loop's depth
    (``serve.decode.resident_ring``).
    """

    def __init__(self, cfg, params, *, max_batch: int, max_seq: int):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = params["embed"].device
        self._prefill = make_prefill_step(cfg)
        self.steps = 0
        self.step_s = 0.0       # host wall time of steps, token copy included
        self.capture_s = 0.0
        # one row's cache bytes at the loop's max_seq
        self.slot_bytes = sum(
            t.numel() * t.element_size() for t in
            loop_cache(params, cfg, 1, max_seq, device="meta").values())
        # loop base: the probed full-batch footprint (every row's cache is
        # allocated with the loop) plus one adoption's staging
        dvec = probe_fn(loop_footprint, params, cfg, max_batch, max_seq)
        self.step_vec = dvec
        self.loop_hbm = dvec.hbm_bytes + self.slot_bytes
        self.step_seconds = max(dvec.est_seconds, 1e-4)

    def loop_vec(self, max_batch: int) -> ResourceVector:
        d = (SLOTS - max_batch) / SLOTS
        return dataclasses.replace(self.step_vec, hbm_bytes=self.loop_hbm,
                                   core_demand=d, bw_demand=d)

    def slot_vec(self, req: ServeRequest) -> ResourceVector:
        return ResourceVector(
            hbm_bytes=0,
            flops=self.step_vec.flops / max(self.max_batch, 1),
            bytes_accessed=self.step_vec.bytes_accessed
            / max(self.max_batch, 1),
            est_seconds=self.step_seconds,
            core_demand=1 / SLOTS, bw_demand=1 / SLOTS)

    def prefill_vec(self, req: ServeRequest) -> ResourceVector:
        return probe_fn(self._prefill, self.params,
                        {"tokens": req.prompt.to(self.device)},
                        uncharged=(0,))

    def prefill(self, req: ServeRequest) -> None:
        logits, cache = self._prefill(self.params,
                                      {"tokens": req.prompt.to(self.device)})
        first = torch.argmax(logits[0])
        _wait(self.device)
        req.first_token = int(first)
        cache = resident_ring(self.cfg, cache, self.max_seq)
        # to pinned host memory on the worker's stream, which the executor
        # synchronises before the prefill's reservation is released
        req.cache = {k: t.to("cpu", non_blocking=True)
                     for k, t in cache.items()}

    def _on_loop(self, state: Dict[str, Any]):
        stream = state["stream"]
        return contextlib.nullcontext() if stream is None \
            else torch.cuda.stream(stream)

    def make_loop_state(self, rows: int) -> Dict[str, Any]:
        dev = self.device
        state: Dict[str, Any] = {
            "cache": loop_cache(self.params, self.cfg, rows, self.max_seq),
            "tokens": torch.zeros(rows, dtype=torch.int32, device=dev),
            "pos": torch.zeros(rows, dtype=torch.int32, device=dev),
            "active": torch.zeros(rows, dtype=torch.int32, device=dev),
            "in_use": [False] * rows, "stream": None, "graph": None}

        def run() -> None:
            loop_step(self.params, self.cfg, state["cache"],
                      state["tokens"], state["pos"], state["active"])

        state["run"] = run
        if dev.type == "cuda":
            state["stream"] = capture_stream(dev)
            state["graph"] = StepGraph(run, state["stream"])
            state["stream"].synchronize()
            self.capture_s = state["graph"].capture_s
        return state

    def adopt(self, state: Dict[str, Any], row: int,
              req: ServeRequest) -> None:
        with self._on_loop(state):
            D.cache_insert(state["cache"], req.cache, row)
            state["tokens"][row] = req.first_token
            state["pos"][row] = req.prompt_len
        req.cache = None  # adopted: the row owns the KV now

    def step(self, state: Dict[str, Any],
             rows: List[Optional[ServeRequest]]) -> None:
        t = time.perf_counter()
        in_use = [r is not None for r in rows]
        with self._on_loop(state):
            if in_use != state["in_use"]:
                state["active"].copy_(torch.tensor(in_use, dtype=torch.int32))
                state["in_use"] = in_use
            if state["graph"] is not None:
                state["graph"].replay()
            else:
                state["run"]()
            _wait(self.device)
            nxt = state["tokens"].tolist()
        self.steps += 1
        self.step_s += time.perf_counter() - t
        for row, req in enumerate(rows):
            if req is not None:
                req.tokens.append(nxt[row])


def _wait(device: torch.device) -> None:
    """Wait for the current stream's work on ``device`` without holding the
    interpreter lock (a stream synchronize releases it), so the pool's
    prefill threads run on while the pump or a prefill waits for the card;
    the host read that follows is then a short copy."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def loop_cache(params, cfg, rows: int, max_seq: int,
               device=None) -> D.Cache:
    """A decode loop's zeroed cache (``init_cache``) on the weights' device,
    bf16 as the reference's, except an ssm conv state, kept in the weights'
    dtype: the reference's decode computes it in that dtype and hands back
    a new array, so its loop's bf16 conv state becomes f32 after the first
    step under f32 weights, where the port writes the state back in place."""
    embed = params["embed"]
    dtype = embed.dtype if cfg.family == "ssm" else torch.bfloat16
    return D.init_cache(cfg, rows, max_seq, dtype=dtype,
                        device=embed.device if device is None else device)


def loop_step(params, cfg, cache, tokens: torch.Tensor, pos: torch.Tensor,
              active: torch.Tensor) -> None:
    """One step of a decode loop, on the card alone: every row decodes at its
    own position; a row in use (``active`` 1) takes its next token (argmax)
    and advances its position, a row not in use keeps both."""
    logits, _ = D.decode_step(params, cfg, cache, tokens, pos)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    tokens.copy_(torch.where(active > 0, nxt, tokens))
    pos.add_(active)


def loop_footprint(params, cfg, max_batch: int, max_seq: int) -> None:
    """What a decode loop allocates, for its probe: the cache and buffers of
    ``max_batch`` rows, then one step."""
    dev = params["embed"].device
    cache = loop_cache(params, cfg, max_batch, max_seq)
    tokens, pos, active = (torch.zeros(max_batch, dtype=torch.int32,
                                       device=dev) for _ in range(3))
    loop_step(params, cfg, cache, tokens, pos, active)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Loop:
    device: int
    host: Task
    rows: List[Optional[ServeRequest]]
    state: Any
    pending: List[ServeRequest] = dataclasses.field(default_factory=list)
    # backend timestamp of this loop's previous decode step; -1 while the
    # loop is idle, so per-step TPOT attribution never charges idle gaps
    last_step_t: float = -1.0

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.rows if r is not None)


class ServeEngine:
    """Continuous-batching serving over a ``Cluster`` (either backend).

    One decode loop per device (``loop_devices`` to restrict), each a
    ``bind_resident`` scheduler resident; requests enter via ``submit`` and
    flow prefill → slot join (``task_grow``) → per-step decode → retire
    (``task_shrink``). Joins that would overrun a device park in the
    scheduler's admission queue; ``violations`` counts device-capacity
    breaches observed after any engine action (always 0 under a memory-safe
    scheduler — asserted by bench_serve)."""

    def __init__(self, cluster: Cluster, model, *, max_batch: int = 8,
                 slo: SLO = SLO(), loop_devices: Optional[Sequence[int]] = None,
                 prefill_priority: int = 10, decode_priority: int = 5,
                 metrics_registry: Optional[MetricsRegistry] = None):
        if max_batch < 1 or max_batch >= SLOTS:
            raise ValueError(f"max_batch must be in [1, {SLOTS - 1}]")
        self.cluster = cluster
        # optional obs.metrics sink: per-request ttft_s/tpot_s histograms
        # recorded as requests resolve (streaming — no end-of-run scan)
        self.metrics_registry = metrics_registry
        self.sched: Scheduler = cluster.sched
        self.model = model
        self.max_batch = max_batch
        self.slo = slo
        self.prefill_priority = prefill_priority
        self.decode_priority = decode_priority
        self._lock = threading.Lock()
        self.requests: List[ServeRequest] = []
        self.loops: Dict[int, _Loop] = {}
        self.join_log: List[Tuple[int, int]] = []  # (rid, device) admissions
        self.violations = 0
        self._sim_tick: Optional[float] = None
        devices = list(loop_devices) if loop_devices is not None \
            else [d.index for d in self.sched.devices]
        for d in devices:
            host = Task(
                units=[UnitTask(fn=None,
                                memobjs=frozenset({f"decode-loop/{d}"}),
                                resources=model.loop_vec(max_batch),
                                name=f"decode-loop/{d}")],
                name=f"decode-loop/{d}", priority=decode_priority,
                slot_budget=max_batch)
            if not self.sched.bind_resident(host, d):
                raise RuntimeError(
                    f"device {d} cannot host a decode loop "
                    f"({model.loop_vec(max_batch).hbm_bytes / 1e9:.2f} GB "
                    f"base + {max_batch} rows)")
            self.loops[d] = _Loop(device=d, host=host,
                                  rows=[None] * max_batch,
                                  state=model.make_loop_state(max_batch))
        self._hosts = tuple(lp.host for lp in self.loops.values())
        self._check_capacity()

    # -- submission ---------------------------------------------------------
    def submit(self, *, prompt=None, prompt_len: Optional[int] = None,
               gen_len: int = 16, deadline_s: Optional[float] = None,
               runner_sleep: bool = False) -> ServeRequest:
        """Stream one request in. ``prompt``: [S] or [1, S] token array (real
        backend) — or pass ``prompt_len`` alone for a NullModel. ``gen_len``
        counts ALL output tokens including the prefill's first. The prefill
        task carries ``deadline_s`` (default: the TTFT SLO) for EDF ranking /
        shedding."""
        if prompt is not None and prompt_len is None:
            prompt = prompt.reshape(1, -1) if prompt.ndim == 1 else prompt
            prompt_len = int(prompt.shape[-1])
        req = ServeRequest(rid=next(_rids), prompt_len=int(prompt_len),
                           gen_len=int(gen_len), arrival_t=self.cluster.now,
                           prompt=prompt)
        with self._lock:
            self.requests.append(req)
        vec = self.model.prefill_vec(req)
        task = Task(units=[UnitTask(fn=None,
                                    memobjs=frozenset({f"req/{req.rid}"}),
                                    resources=vec,
                                    name=f"prefill/{req.rid}")],
                    name=f"prefill/{req.rid}")
        job = Job(tasks=[task], name=f"prefill/{req.rid}")

        def runner(device, req=req):
            self.model.prefill(req)

        runners = [runner] if self.cluster.backend == "live" else None
        self.cluster.submit(
            job, runners=runners, priority=self.prefill_priority,
            deadline_s=deadline_s if deadline_s is not None
            else self.slo.ttft_s,
            on_done=lambda h, req=req: self._on_prefill_done(req, h))
        return req

    def _on_prefill_done(self, req: ServeRequest, handle: JobHandle) -> None:
        status = handle.status
        if status is JobStatus.SHED:
            req.status = RequestStatus.SHED
            return
        if status is not JobStatus.DONE:
            req.status = RequestStatus.FAILED
            req.error = handle.job.error or f"prefill {status.value}"
            return
        req.t_first = self.cluster.now
        req.n_tokens = 1
        if self.metrics_registry is not None:
            self.metrics_registry.hist("ttft_s").record(
                req.t_first - req.arrival_t)
        if req.first_token is not None:
            req.tokens.append(req.first_token)
        if req.gen_len <= 1:
            # single-token request: served entirely by prefill — no slot
            req.t_done = req.t_first
            req.status = RequestStatus.DONE
            return
        req.status = RequestStatus.WAITING_SLOT
        self._request_join(req)

    def _request_join(self, req: ServeRequest) -> None:
        """Grow a decode loop by this request's probed slot delta. The join
        deadline is the request's decode-completion budget under the TPOT
        SLO — EDF then hands freed rows to the tightest-budget joiner."""
        vec = self.model.slot_vec(req)
        slot = Task(units=[UnitTask(fn=None,
                                    memobjs=frozenset({f"slot/{req.rid}"}),
                                    resources=vec,
                                    name=f"slot/{req.rid}")],
                    name=f"slot/{req.rid}", priority=self.decode_priority,
                    deadline_t=req.t_first
                    + self.slo.tpot_s * (req.gen_len - 1))
        req.slot_task = slot
        self.sched.task_grow(slot, self._hosts, self._on_slot_admitted(req))

    def _on_slot_admitted(self, req: ServeRequest):
        def cb(task: Task, placement, epoch: int) -> None:
            if placement is DEADLINE_SHED:
                req.status = RequestStatus.SHED
                req.error = "slot join shed past deadline"
                return
            if placement is None:
                req.status = RequestStatus.FAILED
                req.error = "no decode loop can ever host this slot"
                return
            with self._lock:
                if req.status is not RequestStatus.WAITING_SLOT:
                    # stale re-admission (evicted mid-decode and re-grown):
                    # this engine does not migrate KV rows across devices —
                    # release the fresh admission and fail the request
                    stale = True
                else:
                    stale = False
                    req.join_epoch = epoch
                    req.device = placement
                    self.join_log.append((req.rid, placement))
                    self.loops[placement].pending.append(req)
            if stale:
                self.sched.task_shrink(task, epoch=epoch)
                req.status = RequestStatus.FAILED
                req.error = req.error or "decode row evicted (device died)"
            self._check_capacity()
        return cb

    # -- decode loops -------------------------------------------------------
    def _adopt_pending_locked(self, loop: _Loop) -> None:
        while loop.pending:
            req = loop.pending.pop(0)
            row = loop.rows.index(None)  # slot ledger guarantees a free row
            loop.rows[row] = req
            req.row = row
            req.status = RequestStatus.DECODING
            self.model.adopt(loop.state, row, req)

    def pump(self) -> int:
        """Advance every decode loop one step: adopt admitted joins, decode
        one token per active row, retire finished rows (``task_shrink`` —
        which re-drives parked joins/prefills). Returns the number of tokens
        emitted."""
        emitted = 0
        retired: List[ServeRequest] = []
        # per-decode-step TPOT attribution: observed inter-step gap vs the
        # model's predicted step_seconds, fed to an attached calibration
        # store (one attribute read when profiling is off). Deliberately
        # NOT fed to the SLO drift stream — the live busy-loop pumps
        # faster than the step cadence, which is pacing, not drift.
        store = getattr(self.sched, "_calib", None)
        pred_step = self.model.step_seconds
        with self._lock:
            for loop in self.loops.values():
                self._adopt_pending_locked(loop)
                if loop.n_active == 0:
                    loop.last_step_t = -1.0
                    continue
                self.model.step(loop.state, loop.rows)
                now = self.cluster.now
                if loop.last_step_t >= 0:
                    obs_step = now - loop.last_step_t
                    if store is not None:
                        store.note_step(loop.device, pred_step, obs_step)
                    if self.metrics_registry is not None:
                        self.metrics_registry.hist("decode_step_s").record(
                            obs_step)
                loop.last_step_t = now
                for row, req in enumerate(loop.rows):
                    if req is None:
                        continue
                    req.n_tokens += 1
                    emitted += 1
                    if req.n_tokens >= req.gen_len:
                        loop.rows[row] = None
                        req.row = None
                        req.t_done = now
                        req.status = RequestStatus.DONE
                        if self.metrics_registry is not None \
                                and req.n_tokens > 1:
                            self.metrics_registry.hist("tpot_s").record(
                                req.tpot_s)
                        retired.append(req)
        for req in retired:
            # outside the engine lock: the shrink's drain fires join
            # callbacks inline, which re-enter the engine
            self.sched.task_shrink(req.slot_task, epoch=req.join_epoch)
        if retired:
            self._check_capacity()
        return emitted

    # -- drivers ------------------------------------------------------------
    def run_until(self, t: float) -> None:
        """Sim backend: advance the virtual clock to ``t``, pumping every
        decode loop at the model's step cadence between events."""
        step = self.model.step_seconds
        if self._sim_tick is None:
            self._sim_tick = self.cluster.now + step
        while self._sim_tick <= t + 1e-12:
            self.cluster.run_until(self._sim_tick)
            self.pump()
            self._sim_tick += step
        self.cluster.run_until(t)

    def drain(self, timeout_s: float = 300.0) -> None:
        """Run until every submitted request resolves (DONE/SHED/FAILED)."""
        if self.cluster.backend == "sim":
            limit = self.cluster.now + timeout_s
            while self._unresolved() and self.cluster.now < limit:
                self.run_until(min(self.cluster.now
                                   + self.model.step_seconds, limit))
        else:
            deadline = time.monotonic() + timeout_s
            while self._unresolved():
                self.pump()
                if time.monotonic() > deadline:
                    break
                time.sleep(0)
        left = self._unresolved()
        if left:
            raise TimeoutError(
                f"{len(left)} request(s) unresolved after drain "
                f"(first: {left[0].rid} {left[0].status.value})")

    def _unresolved(self) -> List[ServeRequest]:
        terminal = (RequestStatus.DONE, RequestStatus.SHED,
                    RequestStatus.FAILED)
        with self._lock:
            return [r for r in self.requests if r.status not in terminal]

    def shutdown(self) -> None:
        """Release the loop residents (the cluster itself is the caller's)."""
        for loop in self.loops.values():
            self.sched.task_end(loop.host)
        self.loops.clear()

    # -- invariants / metrics ----------------------------------------------
    def _check_capacity(self) -> None:
        # the MEMORY-hard guarantee is the invariant (compute slots may be
        # legitimately oversubscribed under Alg. 3's time-sharing); the
        # per-loop row bound is asserted separately at adopt time
        for dev in self.sched.devices:
            if dev.used_hbm > dev.total_hbm:
                self.violations += 1
            if self.loops.get(dev.index) is not None \
                    and self.loops[dev.index].host.grown_now \
                    > self.max_batch:
                self.violations += 1

    def metrics(self) -> Dict[str, Any]:
        """Aggregate serving metrics over all resolved requests: goodput is
        DONE requests meeting BOTH SLOs per second of trace time."""
        with self._lock:
            reqs = list(self.requests)
        done = [r for r in reqs if r.status is RequestStatus.DONE]
        ttfts = sorted(r.ttft_s for r in done)
        tpots = sorted(r.tpot_s for r in done if r.n_tokens > 1)
        good = [r for r in done if r.ttft_s <= self.slo.ttft_s
                and r.tpot_s <= self.slo.tpot_s]
        t0 = min((r.arrival_t for r in reqs), default=0.0)
        t1 = max((r.t_done for r in done), default=t0)
        span = max(t1 - t0, 1e-9)

        def pct(xs: List[float], p: float) -> float:
            if not xs:
                return 0.0
            i = min(int(p * (len(xs) - 1) + 0.5), len(xs) - 1)
            return xs[i]

        store = getattr(self.sched, "_calib", None)
        step_attr = store.accuracy_report()["serve_steps"] \
            if store is not None else {}
        return {
            "requests": len(reqs),
            "done": len(done),
            "step_attribution": step_attr,
            "shed": sum(1 for r in reqs
                        if r.status is RequestStatus.SHED),
            "failed": sum(1 for r in reqs
                          if r.status is RequestStatus.FAILED),
            "tokens": sum(r.n_tokens for r in done),
            "goodput_rps": len(good) / span,
            "slo_met_rate": len(good) / max(len(done), 1),
            "p50_ttft_s": pct(ttfts, 0.50),
            "p99_ttft_s": pct(ttfts, 0.99),
            "p50_tpot_s": pct(tpots, 0.50),
            "p99_tpot_s": pct(tpots, 0.99),
            "violations": self.violations,
        }
