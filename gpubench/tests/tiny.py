"""Cells at a size the CPU runs in seconds: the two families' equations at
tiny widths, and an open and a closed mix of short requests."""
from __future__ import annotations

import copy

from gpubench.harness import Cell

HYBRID = {
    "name": "zamba2-tiny", "dtype": "bfloat16", "family": "hybrid",
    "n_layers": 6, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "d_ff": 128, "vocab": 256,
    "ssm": {"state_dim": 16, "conv_width": 4, "expand": 2, "headdim": 16,
            "chunk": 32},
    "hybrid_shared_every": 3, "mlp_act": "gelu_gated", "rope_theta": 10000.0,
    "norm_eps": 1e-05, "kernels": []}
SSM = {
    "name": "falcon-mamba-tiny", "dtype": "bfloat16", "family": "ssm",
    "n_layers": 3, "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
    "vocab": 256,
    "ssm": {"state_dim": 8, "conv_width": 4, "expand": 2, "headdim": 16,
            "chunk": 32},
    "hybrid_shared_every": 0, "mlp_act": "silu_gated", "rope_theta": 10000.0,
    "norm_eps": 1e-05, "kernels": []}
OPEN = {"loop": "open", "rate_per_s": 8.0,
        "prompt": {"dist": "lognormal", "median": 48, "sigma": 0.5,
                   "buckets": [32, 64]},
        "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2,
                   "max": 12},
        "max_batch": 4, "prefill_workers": 2,
        "slo": {"ttft_s": 10.0, "tpot_s": 1.0}}
CLOSED = {"loop": "closed", "clients": 3, "pool": 16,
          "prompt": {"dist": "buckets", "buckets": [16, 24]},
          "output": {"dist": "uniform", "min": 3, "max": 8},
          "max_batch": 2, "prefill_workers": 2,
          "slo": {"ttft_s": 10.0, "tpot_s": 1.0}}
E2E = [{"name": n, "unit": u} for n, u in
       (("tokens_per_s", "tokens/s"), ("setup_s", "s"))]


# above what sound runs read on the CPU (widest gap up to 0.046, mean up to
# 0.0012 over twelve runs), far under what the faults read (an altered
# token alone is a widest gap of logits' whole spread)
LIMITS = {"token_gap": 0.1, "mean_token_gap": 0.005}


def cell(config: dict, mix: dict) -> Cell:
    return Cell(name="tiny", config=copy.deepcopy(config),
                mix=copy.deepcopy(mix), end_to_end=E2E, per_layer=[],
                limits=dict(LIMITS))
