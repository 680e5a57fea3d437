"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpubench/``
and the port (``src/repro_torch``). It needs as many CUDA cards as the
cell asks for, and exits non-zero without a result otherwise. The last
line of standard output is the result, one JSON object; the numbers the
run compared, each beside its limit, are the last lines of standard
error and the result's last key. The kernels build once into
``build/kernels`` inside the checkout (the port's fixed build directory).
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
    ap = argparse.ArgumentParser(prog="gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench.harness import Cell
    cell = Cell.from_benchmark(ROOT, args.workload)
    chips = next(w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"gpubench: the port is not in {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from gpubench.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    for name, v in result["compared"].items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
