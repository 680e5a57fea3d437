"""Fig. 4: MGB Alg. 2 vs Alg. 3 throughput on the 8 workloads, 4xV100.

Paper claim: Alg. 3 averages ~1.21x the throughput of Alg. 2 (optimistic
packing exploits fast completions; Alg. 2 holds jobs back ~30% longer).

Copy of ``benchmarks/fig4_alg2_vs_alg3.py`` with its imports rewritten to
``repro_torch`` and a ``device`` for the probes: the card unless ``--device
cpu`` (``python -m repro_torch.bench.fig4_alg2_vs_alg3 --device cpu``); keep
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
        rows[wname] = {
            "alg2_throughput": r2.throughput, "alg3_throughput": r3.throughput,
            "alg3_over_alg2": r3.throughput / r2.throughput,
            "alg2_makespan_s": r2.makespan, "alg3_makespan_s": r3.makespan,
        }
    avg = sum(r["alg3_over_alg2"] for r in rows.values()) / len(rows)
    out = {"rows": rows, "avg_alg3_over_alg2": avg,
           "paper_claim": {"avg_alg3_over_alg2": 1.21}}
    print("Fig4  Alg3/Alg2 throughput per workload:")
    for wname, r in rows.items():
        print(f"  {wname}: {r['alg3_over_alg2']:.2f}x")
    print(C.check("avg Alg3/Alg2", avg, 1.0, 1.45))
    C.save_json("fig4.json", out)
    return out


if __name__ == "__main__":
    run(**C.cli())
