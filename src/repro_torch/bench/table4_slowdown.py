"""Table IV: per-kernel slowdown vs single-assignment for Alg. 2 and Alg. 3
on the 8 workloads, 4xV100.

Paper claim: Alg. 2 averages 1.8%, Alg. 3 2.5% — both negligible, <1% apart.

Copy of ``benchmarks/table4_slowdown.py`` with its imports rewritten to
``repro_torch`` and a ``device`` for the probes: the card unless ``--device
cpu`` (``python -m repro_torch.bench.table4_slowdown --device cpu``); keep
the two in step.
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.core import workloads as W


def run(device=None) -> dict:
    n_dev = C.SYSTEMS["4xV100"]
    workers = C.MGB_WORKERS["4xV100"]
    rows = {}
    for wname in sorted(W.WORKLOADS):
        jobs = W.workload(wname, device=device)
        r2 = C.run_mgb(jobs, n_dev, workers, alg=2)
        r3 = C.run_mgb(jobs, n_dev, workers, alg=3)
        rows[wname] = {"alg2_pct": r2.mean_slowdown_pct,
                       "alg3_pct": r3.mean_slowdown_pct}
    avg2 = sum(r["alg2_pct"] for r in rows.values()) / len(rows)
    avg3 = sum(r["alg3_pct"] for r in rows.values()) / len(rows)
    out = {"rows": rows, "avg_alg2_pct": avg2, "avg_alg3_pct": avg3,
           "paper_claim": {"avg_alg2_pct": 1.8, "avg_alg3_pct": 2.5}}
    print("Table4 kernel slowdown % (Alg2 / Alg3):")
    for wname, r in rows.items():
        print(f"  {wname}: {r['alg2_pct']:5.2f}% / {r['alg3_pct']:5.2f}%")
    print(C.check("avg Alg2 slowdown %", avg2, 0.0, 3.0))
    print(C.check("avg Alg3 slowdown %", avg3, 0.0, 3.5))
    C.save_json("table4.json", out)
    return out


if __name__ == "__main__":
    run(**C.cli())
