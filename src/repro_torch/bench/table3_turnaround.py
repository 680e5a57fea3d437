"""Table III: MGB average turnaround-time speedup over SA, per mix and size.

Paper claim: 2.0x-4.9x speedups; averages 3.7x (2xP100) and 2.8x (4xV100).

Copy of ``benchmarks/table3_turnaround.py`` with its imports rewritten to
``repro_torch`` and a ``device`` for the probes: the card unless ``--device
cpu`` (``python -m repro_torch.bench.table3_turnaround --device cpu``); keep
the two in step.
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.core import workloads as W

MIXES = {"1:1": (1, 1), "2:1": (2, 1), "3:1": (3, 1), "5:1": (5, 1)}


def run(device=None) -> dict:
    out = {}
    for system, n_dev in C.SYSTEMS.items():
        workers = C.MGB_WORKERS[system]
        rows = {}
        for n_jobs in (16, 32):
            for mix_name, ratio in MIXES.items():
                jobs = W.make_mix(7, n_jobs, ratio, device=device)
                sa = C.run_sa(jobs, n_dev)
                mgb = C.run_mgb(jobs, n_dev, workers, alg=3)
                rows[f"{n_jobs}j_{mix_name}"] = \
                    sa.mean_turnaround / mgb.mean_turnaround
        avg = sum(rows.values()) / len(rows)
        out[system] = {"rows": rows, "avg_speedup": avg}
        print(f"Table3 [{system}] turnaround speedup: " + "  ".join(
            f"{k}:{v:.1f}x" for k, v in rows.items()))
        lo, hi = (1.8, 5.2), (1.6, 4.2)
        band = lo if system == "2xP100" else hi
        print(C.check(f"{system} avg turnaround speedup", avg,
                      band[0], band[1]))
    out["paper_claim"] = {"2xP100_avg": 3.7, "4xV100_avg": 2.8,
                          "max": 4.9}
    C.save_json("table3.json", out)
    return out


if __name__ == "__main__":
    run(**C.cli())
