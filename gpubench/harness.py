"""One run of one cell: set-up, the measured window, the drain, the readers,
and the comparison with the plain reference.

The system under test is the port's continuous engine, wired as
``launch/serve.py::serve_continuous`` wires it: ``TorchModel`` over the
harness's weights, ``MGBAlg3Scheduler`` sized to the card's free memory
less the pool's reserve, ``Cluster`` with the mix's prefill workers, and
``ServeEngine`` with the mix's rows. One harness thread submits the
requests that are due and pumps the decode loop; the prefills run on the
pool's workers.

Everything that belongs to a configuration, a traffic mix or a metric is
read from files found by name: ``gpubench/configs/<config>.json``,
``gpubench/traffic/<mix>.json``, ``gpubench/metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from gpubench import traffic
from gpubench.weights import Weights

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
DRAIN_S = 150.0
# the sample the reference checks: this many requests, the longest whole
# and the others' first CHECK_PREFIX served tokens
CHECK_REQUESTS = 8
CHECK_PREFIX = 64
TERMINAL = ("done", "shed", "failed")


@dataclasses.dataclass
class Cell:
    """A cell as the harness runs it: its configuration and mix (the
    files' contents) and the metrics it reports."""
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    # the numbers ``correct`` compares, each with its limit
    # (``gpubench/limits/<cell>.json``); None where the cell has none yet
    limits: Optional[Dict[str, float]] = None

    @classmethod
    def from_benchmark(cls, root: Path, name: str) -> "Cell":
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"gpubench: no workload {name!r} in "
                             f"BENCHMARK.json ({', '.join(cells)})")
        w = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        config = json.loads((root / conf["file"]).read_text())
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())

        lim = HERE / "limits" / f"{name}.json"

        def mine(m):
            return name in m.get("workloads", [name])
        return cls(name=name, config=config, mix=mix,
                   end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                   per_layer=[m for m in spec["per_layer"] if mine(m)],
                   limits=json.loads(lim.read_text())["limits"]
                   if lim.exists() else None)


def flat_config(c: Dict) -> Dict:
    """The configuration's sizes in one flat mapping (what
    ``gpubench.roofline`` reads)."""
    out = {k: v for k, v in c.items() if k != "ssm"}
    out.update(c["ssm"])
    out["head_dim"] = c.get("head_dim") or (
        c["d_model"] // c["n_heads"] if c.get("n_heads") else 0)
    return out


def program_config(c: Dict):
    """The port's ``ArchConfig`` of the configuration file."""
    from repro_torch.configs.base import ArchConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in c.items() if k in fields and k != "ssm"}
    return ArchConfig(ssm=SSMConfig(**c["ssm"]), **kw)


def load_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Sent:
    """A request of the window: what was drawn, when it was due (the
    scheduled arrival in an open loop, the send in a closed one), the
    engine's request, and what it had emitted when the window closed."""
    draw: traffic.Draw
    due: float
    req: Any
    tokens_at_close: int = 0
    first_in_window: bool = False

    @property
    def tokens(self):
        return self.draw.tokens

    @property
    def served(self):
        return self.req.tokens


@dataclasses.dataclass
class Context:
    """Everything a reader may read (``gpubench/metrics/<name>.py``)."""
    cell: Cell
    flat: Dict[str, Any]
    t0: float
    t1: float
    sent: List[Sent]
    pump_rows: List[int]
    steps: int
    step_s: float
    setup_s: float
    backlog: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)        # (seconds in, prefills not done)
    events: Optional[list] = None      # the Tracer's events (traced run)
    device: Optional[Dict] = None      # trace.summarize (traced run)
    probe_ratio: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _status(req) -> str:
    return req.status.value


def log(msg: str) -> None:
    """A progress line on standard error (the result stays on standard
    output)."""
    print(f"[gpubench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


class Bench:
    """The system under test for one cell, built once: the kernels, the
    weights (``fill`` draws them from a seed, in place), the ``TorchModel``
    over them, every prompt length of the mix probed and prefilled once.
    ``window`` then builds the scheduler, the cluster and the engine,
    drives one measured window and drains it; ``check`` holds what it
    served against the plain reference."""

    def __init__(self, cell: Cell, device: str, trace: bool,
                 hooks: Optional[Dict[str, Callable]] = None) -> None:
        from repro_torch.serve.engine import ServeRequest, TorchModel
        self.cell, self.trace = cell, trace
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        c, mix = cell.config, cell.mix
        self.flat = flat_config(c)
        if self.cuda:
            from repro_torch.kernels.build import build_all
            build_all(tuple(c["kernels"]))
            log("kernels loaded")
        self.weights = Weights(c, getattr(torch, c["dtype"]), self.dev)
        self.max_batch = int(mix["max_batch"])
        model_cls = TorchModel
        if trace:
            from torch.profiler import record_function

            class TracedModel(TorchModel):
                def prefill(self, req):
                    with record_function("prefill"):
                        super().prefill(req)
            model_cls = TracedModel
        self.model = model_cls(program_config(c), self.weights.params,
                               max_batch=self.max_batch,
                               max_seq=traffic.max_len(mix))
        if hooks and "model" in hooks:
            hooks["model"](self.model)
        self._request = ServeRequest
        self.warmed = False
        self.probe_ratio: Optional[float] = None
        self.peak = 0

    def setup(self, seed: int) -> None:
        """Draw the weights from ``seed``; the first time, warm every prompt
        length of the mix (its probe and one prefill), and in a traced run
        on the card measure the probe against the longest prefill alone."""
        self.weights.fill(seed)
        if self.warmed:
            return
        warm = {}
        for s in traffic.buckets(self.cell.mix):
            r = self._request(rid=-1, prompt_len=s, gen_len=2,
                              arrival_t=0.0,
                              prompt=torch.zeros(1, s, dtype=torch.long))
            self.model.prefill_vec(r)
            self.model.prefill(r)
            warm[s] = r
        if self.trace and self.cuda:
            dev, longest = self.dev, warm[max(warm)]
            vec = self.model.prefill_vec(longest)
            torch.cuda.synchronize(dev)
            self.peak = _peak(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            self.model.prefill(longest)
            torch.cuda.synchronize(dev)
            self.probe_ratio = vec.hbm_bytes / max(
                1, torch.cuda.max_memory_allocated(dev) - base)
        self.warmed = True
        log(f"warmed {len(warm)} prompt lengths")

    def window(self, seed: int, seconds: float, t_start: float,
               mix: Optional[Dict] = None) -> Context:
        """One measured window of ``seconds`` under ``mix`` (the cell's by
        default), then the drain; the engine is shut down before this
        returns, so only the weights stay on the card."""
        from repro_torch.core.cluster import Cluster
        from repro_torch.core.scheduler import MGBAlg3Scheduler
        from repro_torch.launch.serve import pool_reserve, serving_devices
        from repro_torch.serve.engine import SLO, ServeEngine

        mix = mix or self.cell.mix
        dev, cuda, trace, model = self.dev, self.cuda, self.trace, self.model
        workers = int(mix["prefill_workers"])
        devices, hbm = serving_devices(1, None if cuda else "cpu")
        sched = MGBAlg3Scheduler(
            1, hbm_per_device=hbm - pool_reserve(devices, workers))
        cluster = Cluster(sched, workers=workers, devices=devices,
                          trace=trace)
        slo = mix.get("slo", {})
        eng = ServeEngine(cluster, model, max_batch=self.max_batch,
                          slo=SLO(ttft_s=slo.get("ttft_s", 2.0),
                                  tpot_s=slo.get("tpot_s", 0.2)))
        # one short request through the whole path: prefill task, join,
        # adopt, replayed decode steps, retire
        lo = min(traffic.buckets(mix))
        eng.submit(prompt=torch.zeros(1, lo, dtype=torch.long), gen_len=3)
        eng.drain(timeout_s=DRAIN_S)
        dtrace = None
        if trace and cuda:
            from gpubench.trace import TRACE_S, DeviceTrace
            DeviceTrace.warm()
            dtrace = DeviceTrace()
        draws = traffic.draws(mix, seed, seconds, self.cell.config["vocab"])
        prompts = [torch.from_numpy(d.tokens)[None] for d in draws]
        gc.collect()
        if cuda:
            torch.cuda.synchronize(dev)

        # ---- the measured window ----------------------------------------
        sent: List[Sent] = []
        rows: List[int] = []
        backlog: List[Tuple[float, int]] = []
        steps0, step_s0 = model.steps, model.step_s
        t0 = time.monotonic()
        setup_s = time.time() - t_start
        t1 = t0 + seconds
        trace_at = t1 - min(TRACE_S, seconds) if dtrace is not None \
            else None
        open_loop = mix["loop"] == "open"
        clients: List[Optional[Sent]] = [None] * int(mix.get("clients", 0))
        nxt = 0
        span = _spans(trace)

        def send(i: int, due: float) -> Sent:
            with span("submit"):
                req = eng.submit(prompt=prompts[i],
                                 gen_len=draws[i].gen_len)
            s = Sent(draw=draws[i], due=due, req=req)
            sent.append(s)
            return s

        while True:
            now = time.monotonic()
            if now >= t1:
                break
            if trace_at is not None and now >= trace_at:
                dtrace.start()
                trace_at = None
            if open_loop:
                while nxt < len(draws) and t0 + draws[nxt].due_s <= now:
                    send(nxt, t0 + draws[nxt].due_s)
                    nxt += 1
            else:
                for k, s in enumerate(clients):
                    if s is None or _status(s.req) in TERMINAL:
                        clients[k] = send(nxt % len(draws),
                                          time.monotonic())
                        nxt += 1
            rows.append(sum(lp.n_active for lp in eng.loops.values()))
            if len(backlog) < (now - t0) * 4:  # four samples a second
                backlog.append((now - t0, sum(1 for s in sent
                                              if s.req.t_first < 0)))
            with span("pump"):
                emitted = eng.pump()
            if not emitted:
                wake = t1
                if open_loop and nxt < len(draws):
                    wake = min(wake, t0 + draws[nxt].due_s)
                with span("wait"):
                    time.sleep(max(0.0, min(0.001,
                                            wake - time.monotonic())))
        t_close = time.monotonic()
        log(f"window closed after {t_close - t0:.1f} s: {len(sent)} sent, "
            f"set-up {setup_s:.1f} s")
        for s in sent:
            s.tokens_at_close = len(s.req.tokens)
            s.first_in_window = 0 <= s.req.t_first <= t_close
        steps, step_s = model.steps - steps0, model.step_s - step_s0
        if dtrace is not None and trace_at is None:
            dtrace.stop()
        # ---- drain, then free the program's state -----------------------
        try:
            eng.drain(timeout_s=DRAIN_S)
        except TimeoutError as e:
            log(str(e))
        log(f"drained in {time.monotonic() - t_close:.1f} s")
        self.peak = max(self.peak, _peak(dev))
        events = list(cluster.trace.events()) \
            if cluster.trace is not None else None
        eng.shutdown()
        cluster.shutdown()
        del eng, cluster, sched
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ctx = Context(cell=self.cell, flat=self.flat, t0=t0, t1=t_close,
                      sent=sent, pump_rows=rows, steps=steps, step_s=step_s,
                      setup_s=setup_s, backlog=backlog, events=events,
                      probe_ratio=self.probe_ratio)
        if dtrace is not None and trace_at is None:
            from gpubench.trace import summarize
            t = time.monotonic()
            ctx.device = summarize(dtrace.events())
            log(f"device trace read in {time.monotonic() - t:.1f} s")
        return ctx

    def check(self, ctx: Context, seed: int,
              control: bool = False) -> Dict[str, Any]:
        """What the window in ``ctx`` served, against the plain reference:
        ``lost_requests`` (neither done nor shed) and the token gaps of
        ``compare.token_gaps`` over a sample of the finished requests."""
        from gpubench.reference import compare
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        done = [s for s in ctx.sent if _status(s.req) == "done"]
        # a shed request was refused (``failed`` counts it); one that
        # failed or never resolved was lost
        lost = sum(1 for s in ctx.sent if _status(s.req) not in
                   ("done", "shed"))
        checked = compare.sample(done, seed, CHECK_REQUESTS, CHECK_PREFIX)
        t = time.monotonic()
        out = compare.token_gaps(self.weights.params, self.cell.config,
                                 checked, self.dev, control=control)
        log(f"reference checked {out['tokens']} tokens of {len(checked)} "
            f"requests in {time.monotonic() - t:.1f} s")
        out["lost_requests"] = lost
        return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules the run may not load, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float,
             hooks: Optional[Dict[str, Callable]] = None) -> Dict[str, Any]:
    """One run of ``cell``. Returns the result line's object."""
    bench = Bench(cell, device, trace, hooks)
    bench.setup(seed)
    log(f"model built and warmed at {time.time() - t_start:.1f} s")
    ctx = bench.window(seed, seconds, t_start)
    bench.model = None
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    got = bench.check(ctx, seed)
    compared, correct = judge(got, cell.limits)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"gpubench: the run loaded {', '.join(found)}")
    due = [s for s in ctx.sent if s.due < ctx.t1]
    cuda = bench.cuda
    result: Dict[str, Any] = dict(
        correct=bool(correct),
        attempted=len(due),
        failed=sum(1 for s in due if _status(s.req) in ("shed", "failed")),
        metrics=metrics,
        device={"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(bench.dev) if cuda
                else "cpu",
                "count": 1, "memory_peak_bytes": int(bench.peak)})
    if ctx.device is not None:
        result["device"]["busy_s"] = ctx.device["busy_s"]
        result["device"]["window_s"] = ctx.device["window_s"]
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in ctx.device["device_ops"]],
            "idle_gaps": [list(kv) for kv in ctx.device["idle_gaps"]]}
    result["compared"] = compared
    return result


def judge(got: Dict[str, Any], limits: Optional[Dict[str, float]]
          ) -> Tuple[Dict[str, Dict[str, Any]], bool]:
    """The numbers compared, each beside its limit, and whether the run is
    correct: no request lost, some tokens checked, and every number the
    cell's limits name at or under its limit. A cell without limits is
    never correct."""
    compared = {"lost_requests": {"value": got["lost_requests"],
                                  "limit": 0}}
    for name, limit in (limits or {}).items():
        compared[name] = {"value": got[name], "limit": limit}
    correct = limits is not None and got["tokens"] > 0 and all(
        v["value"] <= v["limit"] for v in compared.values())
    return compared, bool(correct)


def _spans(on: bool):
    if on:
        from torch.profiler import record_function
        return record_function
    import contextlib
    return lambda name: contextlib.nullcontext()
