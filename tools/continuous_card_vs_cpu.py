"""Reduced models served continuously on the card against the same weights
served continuously on the CPU, repeated over seeds and pool sizes.

    python3 tools/continuous_card_vs_cpu.py [--seeds 4] [--workers 1 2]

chip_smoke's ``phase_continuous_reduced`` runs this comparison once per
model (weights from seed 0, prompts from seed 1, 2 pool workers). This
repeats it for each seed in ``range(--seeds)`` (weights and prompts both
drawn from it) and each pool size, for reduced gemma2-9b (prompt 100),
falcon-mamba-7b and mixtral-8x7b (prompt 128): 6 requests through
``ServeEngine`` + ``TorchModel`` with a loop of 4 rows, 9 tokens each, in
f32. A run prints whether every request's tokens are equal; where they are
not, the first differing request and token, and that request's batch-1
prefill logits on the card (default stream, alone) against the CPU's: max
abs difference and the CPU's top-2 gap. Prints the card's name and power
limit first; exits 1 if any run disagreed. Needs one CUDA card; imports no
JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = (("gemma2-9b", 100), ("falcon-mamba-7b", 128), ("mixtral-8x7b", 128))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("continuous_card_vs_cpu: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.scheduler import MGBAlg3Scheduler
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import make_prefill_step
    from repro_torch.serve.engine import SLO, ServeEngine, TorchModel
    build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card-vs-cpu] {card}", flush=True)
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)

    def serve(cfg, params, prompts, dev, workers):
        p = _to(params, dev)
        cluster = Cluster(MGBAlg3Scheduler(1, hbm_per_device=64 << 30),
                          workers=workers, devices=[dev])
        eng = ServeEngine(cluster, TorchModel(cfg, p, max_batch=4,
                                              max_seq=prompts.shape[1] + 9),
                          max_batch=4, slo=SLO(600.0, 600.0))
        reqs = [eng.submit(prompt=prompts[i:i + 1], gen_len=9)
                for i in range(prompts.shape[0])]
        eng.drain()
        m = eng.metrics()
        eng.shutdown()
        cluster.shutdown()
        if m["done"] != len(reqs) or m["violations"]:
            sys.exit(f"continuous_card_vs_cpu: {cfg.name} on {dev}: "
                     f"{m['done']}/{len(reqs)} done, {m['violations']} "
                     f"violations")
        return [r.tokens for r in reqs]

    bad = 0
    for arch, prompt_len in ARCHS:
        cfg = get_arch(arch).reduced()
        for seed in range(args.seeds):
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 torch.float32, cpu)
            prompts = torch.randint(
                0, cfg.vocab, (6, prompt_len),
                generator=torch.Generator().manual_seed(seed + 1))
            want = serve(cfg, params, prompts, cpu, 2)
            for workers in args.workers:
                got = serve(cfg, params, prompts, gpu, workers)
                line = (f"[card-vs-cpu] reduced {arch}, seed {seed}, "
                        f"{workers} worker(s): tokens equal "
                        f"{got == want}")
                if got != want:
                    bad += 1
                    r = next(i for i in range(len(got)) if got[i] != want[i])
                    t = next(j for j in range(len(got[r]))
                             if got[r][j] != want[r][j])
                    prefill = make_prefill_step(cfg)
                    lc = prefill(params, {"tokens": prompts[r:r + 1]})[0][0]
                    lg = prefill(_to(params, gpu),
                                 {"tokens": prompts[r:r + 1].to(gpu)}
                                 )[0][0].cpu()
                    top = torch.topk(lc, 2).values
                    line += (f"; first at request {r}, token {t} (card "
                             f"{got[r]}, CPU {want[r]}); that request's "
                             f"prefill logits card vs CPU max abs "
                             f"{float((lc - lg).abs().max()):.3e}, CPU "
                             f"top-2 gap {float(top[0] - top[1]):.3e}")
                print(line, flush=True)
    print(f"[card-vs-cpu] {bad} run(s) disagreed", flush=True)
    sys.exit(1 if bad else 0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


if __name__ == "__main__":
    main()
