"""Read the numbers ``correct`` compares, on many seeds in one process: for
each seed the weights and the traffic are drawn anew, one window of the
cell's own load is served and drained, and the served tokens are held
against the plain reference; with ``--control`` the lower-precision
control (``reference/precision.py``) is read on the same prompts and
tokens, and with ``--fault`` a fault of ``gpubench/faults.py`` is planted
in the program. One JSON line a seed; the limits in
``limits/<cell>.json`` are set from these readings (PERF.md lists them).

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control] [--fault altered|half|frozen]
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("altered", "half", "frozen"),
                    help="plant this fault of gpubench/faults.py")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpubench import faults
    from gpubench.harness import Bench, Cell
    cell = Cell.from_benchmark(ROOT, args.workload)
    hooks = {"model": faults.altered} if args.fault == "altered" else None
    if args.fault in faults.STEP_FAULTS:
        from repro_torch.serve import engine
        engine.loop_step = faults.STEP_FAULTS[args.fault](engine.loop_step)
    bench = Bench(cell, "cuda:0", trace=False, hooks=hooks)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        bench.setup(seed)
        ctx = bench.window(seed, args.seconds, t)
        t_ref = time.time()
        got = bench.check(ctx, seed, control=args.control)
        print("[calibrate] " + json.dumps({
            "workload": args.workload, "fault": args.fault, "seed": seed,
            "sent": len(ctx.sent), **got, "check_s": time.time() - t_ref,
            "seed_s": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
