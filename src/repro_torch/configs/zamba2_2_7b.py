"""Zamba2 2.7B — hybrid: Mamba2 backbone + shared attention block. [arXiv:2411.15242]

Copy of ``src/repro/configs/zamba2_2_7b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, headdim=64),
    hybrid_shared_every=6,
    mlp_act="gelu_gated",
    optimizer_moment_dtype="float32",
    remat_policy="full",
    num_microbatches=4,
)
