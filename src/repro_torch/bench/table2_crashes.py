"""Table II: percentage of crashed jobs under the memory-unsafe CG scheduler,
by worker count and mix ratio, on both systems.

Paper claim: erratic and increasing with workers — 0-22% on P100s and
0-50% on V100s; the 3/6-worker row is near zero, the 6/12 row is the worst.

Copy of ``benchmarks/table2_crashes.py`` with its imports rewritten to
``repro_torch`` and a ``device`` for the probes: the card unless ``--device
cpu`` (``python -m repro_torch.bench.table2_crashes --device cpu``); keep
the two in step.
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.core import workloads as W

MIXES = {"1:1": (1, 1), "2:1": (2, 1), "3:1": (3, 1), "5:1": (5, 1)}
# paper's worker rows: {P100 workers}/{V100 workers}
WORKER_ROWS = [(3, 6), (4, 8), (5, 10), (6, 12)]
N_JOBS = 32


def run(device=None) -> dict:
    out = {}
    for system, n_dev in C.SYSTEMS.items():
        col = 0 if system == "2xP100" else 1
        rows = {}
        for wp, wv in WORKER_ROWS:
            workers = (wp, wv)[col]
            row = {}
            for mix_name, ratio in MIXES.items():
                jobs = W.make_mix(123, N_JOBS, ratio, device=device)
                r = C.run_cg(jobs, n_dev, workers)
                row[mix_name] = 100.0 * r.crashed / N_JOBS
            rows[f"{workers}w"] = row
        out[system] = rows
        print(f"Table2 [{system}] CG crash % (rows=workers, cols=mix):")
        for wname, row in rows.items():
            print(f"  {wname:4s} " + "  ".join(
                f"{m}:{v:5.1f}%" for m, v in row.items()))
    # the paper's qualitative claims: monotone-ish growth with workers,
    # non-trivial crash rates at high worker counts
    for system in C.SYSTEMS:
        rows = list(out[system].values())
        first = sum(rows[0].values()) / 4
        last = sum(rows[-1].values()) / 4
        print(C.check(f"{system} crash% (min workers)", first, 0.0, 20.0))
        print(C.check(f"{system} crash% (max workers)", last, 10.0, 60.0))
    C.save_json("table2.json", out)
    return out


if __name__ == "__main__":
    run(**C.cli())
