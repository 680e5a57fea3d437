"""Static serving with one and with four pool workers sharing one card,
under two interpreter switch intervals.

    python3 tools/pool_workers.py [--arch gemma2-9b] [--prompt-len 1000]

Each pool worker runs its batch's prefill eagerly, then one eager decode
step and a graph capture, then graph replays (``serve.decode.
greedy_generate``). The eager parts are Python launching kernels one by
one; threads take turns on the interpreter lock, and a thread that gives it
up around a call waits up to ``sys.getswitchinterval()`` to have it back
while another thread computes. This prints tokens/s, TTFT and TPOT of the
same 32 requests (8 batches of 4, 32 tokens each, full width, bf16) for 1
and 4 workers at the default interval (5 ms) and at 0.5 ms, on one card,
with the card's name and power limit, and where a batch's time went: for
its prefill and for its decode graph's warm-up step and capture, the mean
per batch of three times: ``host``, until the Python call returns (the
launches, and any wait of the host inside them); ``stream``, between CUDA
events recorded on the worker's stream before and after (the work's span
on the card, stretched by other workers' kernels sharing it); ``wall``,
until the stream is synchronised. The rest of TPOT is the replays. Needs
one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    spent = {"prefill": [], "warm-up + capture": []}
    lock = threading.Lock()

    def timed(what, fn):
        def run(*a, **k):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            t = time.perf_counter()
            out = fn(*a, **k)
            host = time.perf_counter() - t
            end.record(stream)
            stream.synchronize()
            wall = time.perf_counter() - t
            if threading.current_thread() is not threading.main_thread():
                with lock:  # a pool worker's task (the probe runs on main)
                    spent[what].append(
                        (host, start.elapsed_time(end) / 1e3, wall))
            return out
        return run

    def mean(v, i):
        return sum(x[i] for x in v) / len(v) * 1e3

    make_prefill = S.make_prefill_step
    S.make_prefill_step = lambda cfg: timed("prefill", make_prefill(cfg))
    SD.StepGraph.__init__ = timed("warm-up + capture", SD.StepGraph.__init__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[pool] {card}", flush=True)
    default = sys.getswitchinterval()
    try:
        for interval in (default, 0.0005):
            sys.setswitchinterval(interval)
            for workers in (1, 4):
                for v in spent.values():
                    v.clear()
                res = S.serve(args.arch, requests=32, batch=4,
                              prompt_len=args.prompt_len, gen_len=32,
                              full=True, param_dtype=torch.bfloat16,
                              workers=workers)
                print(f"[pool] {args.arch}, switch interval "
                      f"{interval * 1e3:.1f} ms, {workers} worker(s): "
                      f"{res['completed']}/{res['batches']} batches, "
                      f"{res['tokens_per_s']:.1f} tok/s; TTFT p50/p99 "
                      f"{res['p50_ttft_s'] * 1e3:.1f}/"
                      f"{res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
                      f"{res['p50_tpot_s'] * 1e3:.2f}/"
                      f"{res['p99_tpot_s'] * 1e3:.2f} ms; per batch "
                      + "; ".join(f"{k} host {mean(v, 0):.1f}, stream "
                                  f"{mean(v, 1):.1f}, wall {mean(v, 2):.1f} "
                                  f"ms" for k, v in spent.items() if v),
                      flush=True)
                del res
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        sys.setswitchinterval(default)


if __name__ == "__main__":
    main()
