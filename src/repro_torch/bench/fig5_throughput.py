"""Fig. 5: SA / CG / MGB throughput on both systems, normalized to SA.

Paper claims: MGB/SA 1.8-2.5x (avg 2.2x) on 2xP100, 1.4-2.5x (avg 2.0x) on
4xV100; MGB/CG +64% (P100) and +41% (V100) on average, with CG sometimes at
or below SA because of crashes.

Copy of ``benchmarks/fig5_throughput.py`` with its imports rewritten to
``repro_torch`` and a ``device`` for the probes: the card unless ``--device
cpu`` (``python -m repro_torch.bench.fig5_throughput --device cpu``); keep
the two in step.
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.core import workloads as W


def run(device=None) -> dict:
    out = {}
    for system, n_dev in C.SYSTEMS.items():
        workers = C.MGB_WORKERS[system]
        sweep = [n_dev * k for k in (1, 2, 3, 4, 5, 6)]
        rows = {}
        for wname in sorted(W.WORKLOADS):
            jobs = W.workload(wname, device=device)
            sa = C.run_sa(jobs, n_dev)
            mgb = C.run_mgb(jobs, n_dev, workers, alg=3)
            cg, cg_w = C.best_cg(jobs, n_dev, sweep)
            rows[wname] = {
                "sa": sa.throughput, "mgb": mgb.throughput,
                "cg": cg.throughput if cg else 0.0,
                "cg_workers": cg_w,
                "cg_crashed": cg.crashed if cg else -1,
                "mgb_over_sa": mgb.throughput / sa.throughput,
                "mgb_over_cg": (mgb.throughput / cg.throughput
                                if cg and cg.throughput else float("inf")),
            }
        avg_sa = sum(r["mgb_over_sa"] for r in rows.values()) / len(rows)
        avg_cg = sum(r["mgb_over_cg"] for r in rows.values()) / len(rows)
        out[system] = {"rows": rows, "avg_mgb_over_sa": avg_sa,
                       "avg_mgb_over_cg": avg_cg}
        print(f"Fig5 [{system}] MGB/SA per workload: " + "  ".join(
            f"{w}:{r['mgb_over_sa']:.2f}x" for w, r in rows.items()))
        lo, hi = (1.6, 2.7) if system == "2xP100" else (1.3, 2.7)
        print(C.check(f"{system} avg MGB/SA", avg_sa, lo, hi))
        print(C.check(f"{system} avg MGB/CG", avg_cg, 1.0, 2.2))
    out["paper_claim"] = {
        "2xP100_avg_mgb_over_sa": 2.2, "4xV100_avg_mgb_over_sa": 2.0,
        "2xP100_mgb_over_cg_pct": 64, "4xV100_mgb_over_cg_pct": 41}
    C.save_json("fig5.json", out)
    return out


if __name__ == "__main__":
    run(**C.cli())
