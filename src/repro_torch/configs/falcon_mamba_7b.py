"""Falcon-Mamba 7B — pure Mamba-1, attention-free. [arXiv:2410.05355]

Copy of ``src/repro/configs/falcon_mamba_7b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, expand=2),
    optimizer_moment_dtype="float32",
    remat_policy="full",
    num_microbatches=8,
)
