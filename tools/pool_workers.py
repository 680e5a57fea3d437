"""Static serving with one and with four pool workers sharing one card, and
where each batch's time goes.

    python3 tools/pool_workers.py [--arch gemma2-9b] [--prompt-len 1000]

Each pool worker runs its batch's prefill eagerly, then the decode over
the decoder it keeps (``serve.decode.GreedyDecoder.generate``: at the
worker's first batch an eager warm-up step and a graph capture, then graph
replays; at its later batches replays only). The eager parts are Python
launching kernels one by one, and threads take turns on the interpreter
lock. This serves the same 32 requests (8 batches of 4, 32 tokens each,
full width, bf16) with 1 and with 4 workers on one card, and prints for
each run:

* tokens/s, TTFT and TPOT, with the card's name and power limit;
* for each phase of a batch (``prefill``; ``decode``, the whole of
  ``generate``; inside it ``warm-up``, ``capture`` and, inside the
  capture, ``capture_end``, the graph's instantiation) the mean per span
  of ``host`` (until the Python call returns), ``stream`` (between CUDA
  events on the worker's stream, not read inside a capture) and ``wall``
  (until the stream is synchronised), and the phase's count;
* the caching allocator's counters over the run (``torch.cuda.
  memory_stats``: ``num_alloc_retries``, ``num_sync_all_streams``,
  ``num_device_alloc``, ``num_device_free``) and summed over each phase's
  spans (a span sees every thread's events, as the allocator is shared);
* a sampled stack of every pool thread (a watcher thread reading
  ``sys._current_frames()`` every millisecond): for each phase, the share
  of samples by the thread's kernel state (``/proc/self/task/<tid>/
  syscall``: ``futex`` is a wait on a lock, the interpreter's or a native
  mutex; ``ioctl`` a wait inside the CUDA driver; ``running`` code on a
  core) and the most frequent innermost Python lines. While the watcher
  samples, it holds the interpreter lock, so every other thread is either
  waiting for it or inside native code that released it.

Then one batch alone on a card with nothing else allocated: the task's
probe plus what its worker keeps (``launch.serve.pool_reserve``) against
``torch.cuda.max_memory_allocated``. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("num_alloc_retries", "num_sync_all_streams", "num_device_alloc",
         "num_device_free")
PHASES = ("prefill", "decode", "warm-up", "capture", "capture_end")
SYSCALLS = {"202": "futex", "16": "ioctl", "7": "poll", "230": "nanosleep",
            "running": "running"}


def thread_state(native_id: int) -> str:
    try:
        with open(f"/proc/self/task/{native_id}/syscall") as f:
            first = f.read().split(" ", 1)[0].strip()
        return SYSCALLS.get(first, f"syscall {first}")
    except OSError:
        try:
            with open(f"/proc/self/task/{native_id}/stat") as f:
                return "state " + f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            return "unknown"


class Recorder:
    """Per-phase host, stream and wall times, allocator counter deltas and
    stack samples of the pool threads."""

    def __init__(self, torch):
        self.torch = torch
        self.lock = threading.Lock()
        self.phase_of = {}   # thread ident -> (native id, [phase stack])
        self.reset()
        self.stop = threading.Event()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def reset(self) -> None:
        with self.lock:
            self.times = collections.defaultdict(list)
            self.stats = collections.defaultdict(collections.Counter)
            self.samples = collections.defaultdict(collections.Counter)
            self.states = collections.defaultdict(collections.Counter)
        self.stats0 = self.torch.cuda.memory_stats()

    def _watch(self) -> None:
        while not self.stop.wait(0.001):
            frames = sys._current_frames()
            with self.lock:
                for ident, (nid, stack) in list(self.phase_of.items()):
                    frame = frames.get(ident)
                    if frame is None or not stack:
                        continue
                    where = (f"{frame.f_code.co_name}@"
                             f"{os.path.basename(frame.f_code.co_filename)}:"
                             f"{frame.f_lineno}")
                    state = thread_state(nid)
                    self.samples[stack[-1]][(state, where)] += 1
                    self.states[stack[-1]][state] += 1

    @contextlib.contextmanager
    def phase(self, name: str, on_stream: bool = True):
        torch = self.torch
        pool = threading.current_thread() is not threading.main_thread()
        ident = threading.get_ident()
        if pool:
            with self.lock:
                entry = self.phase_of.get(ident)
                if entry is None or not entry[1]:  # idents are reused
                    entry = self.phase_of[ident] = (
                        threading.get_native_id(), [])
                entry[1].append(name)
        stream = torch.cuda.current_stream()
        if on_stream:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        before = torch.cuda.memory_stats()
        t = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t
            span, wall = float("nan"), float("nan")
            if on_stream:
                end.record(stream)
                stream.synchronize()
                wall = time.perf_counter() - t
                span = start.elapsed_time(end) / 1e3
            after = torch.cuda.memory_stats()
            if pool:
                with self.lock:
                    self.phase_of[ident][1].pop()
                    self.times[name].append((host, span, wall))
                    for k in STATS:
                        self.stats[name][k] += after.get(k, 0) \
                            - before.get(k, 0)

    def report(self) -> str:
        now = self.torch.cuda.memory_stats()
        lines = ["allocator over the run: " + ", ".join(
            f"{k} {now.get(k, 0) - self.stats0.get(k, 0)}" for k in STATS)]
        for name in PHASES:
            v = self.times.get(name)
            if not v:
                continue

            def mean(i):
                return sum(x[i] for x in v) / len(v) * 1e3
            lines.append(
                f"{name}: {len(v)} spans, per span host {mean(0):.1f}, "
                f"stream {mean(1):.1f}, wall {mean(2):.1f} ms; allocator "
                + ", ".join(f"{k} {self.stats[name][k]}" for k in STATS))
            total = sum(self.states[name].values())
            if total:
                lines.append(f"  {name} samples {total}: " + ", ".join(
                    f"{s} {c / total:.1%}"
                    for s, c in self.states[name].most_common()))
                for (s, where), c in self.samples[name].most_common(6):
                    lines.append(f"    {c / total:6.1%} {s:8s} {where}")
        return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--prompt-len", type=int, default=1000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("pool_workers: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.launch import serve as S
    from repro_torch.serve import decode as SD
    build.build_all()  # outside the timed runs
    rec = Recorder(torch)

    def phased(name, fn):
        def run(*a, **k):
            with rec.phase(name):
                return fn(*a, **k)
        return run

    def step_graph_init(self, step, stream):
        # serve.decode.StepGraph.__init__, its parts timed apart
        self.stream = stream
        with SD.StepGraph._TURNS, torch.cuda.stream(stream):
            with rec.phase("warm-up"):
                step()
            t = time.perf_counter()
            with rec.phase("capture", on_stream=False):
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin(capture_error_mode="thread_local")
                step()
                with rec.phase("capture_end", on_stream=False):
                    self.graph.capture_end()
        self.capture_s = time.perf_counter() - t
        SD.CAPTURES.add()

    S.make_prefill_step = (lambda make: lambda cfg: phased(
        "prefill", make(cfg)))(S.make_prefill_step)
    SD.GreedyDecoder.generate = phased("decode", SD.GreedyDecoder.generate)
    SD.StepGraph.__init__ = step_graph_init
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[pool] {card}", flush=True)
    try:
        for workers in (1, 4):
            gc.collect()
            torch.cuda.empty_cache()
            rec.reset()
            res = S.serve(args.arch, requests=32, batch=4,
                          prompt_len=args.prompt_len, gen_len=32,
                          full=True, param_dtype=torch.bfloat16,
                          workers=workers)
            print(f"[pool] {args.arch}, {workers} worker(s): "
                  f"{res['completed']}/{res['batches']} batches, "
                  f"{res['tokens_per_s']:.1f} tok/s in {res['wall_s']:.2f} "
                  f"s; TTFT p50/p99 {res['p50_ttft_s'] * 1e3:.1f}/"
                  f"{res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
                  f"{res['p50_tpot_s'] * 1e3:.2f}/"
                  f"{res['p99_tpot_s'] * 1e3:.2f} ms", flush=True)
            print("\n".join("[pool]   " + line
                            for line in rec.report().splitlines()),
                  flush=True)
            del res
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alone = S.serve(args.arch, requests=4, batch=4,
                        prompt_len=args.prompt_len, gen_len=32, full=True,
                        param_dtype=torch.bfloat16, workers=1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        task, kept = alone["probe"].hbm_bytes, alone["kept_per_worker"]
        print(f"[pool] {args.arch} one batch alone: probe {task} B + kept "
              f"by its worker {kept.hbm_bytes} B = {task + kept.hbm_bytes} "
              f"B vs observed max_memory_allocated {peak} B "
              f"({(task + kept.hbm_bytes) / peak:.4f})", flush=True)
    finally:
        rec.stop.set()
        rec.watcher.join(timeout=5)


if __name__ == "__main__":
    main()
