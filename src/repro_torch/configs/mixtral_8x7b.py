"""Mixtral 8x7B — MoE, 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

Copy of ``src/repro/configs/mixtral_8x7b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    moe=MoEConfig(num_experts=8, top_k=2),
    sliding_window=4096,
    mlp_act="silu_gated",
    rope_theta=1e6,
    optimizer_moment_dtype="float32",
    remat_policy="full",
    seq_shard_activations=True,
    num_microbatches=4,
)
