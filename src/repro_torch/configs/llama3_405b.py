"""Llama-3 405B — dense, GQA kv=8, 128k vocab. [arXiv:2407.21783]

Copy of ``src/repro/configs/llama3_405b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    mlp_act="silu_gated",
    rope_theta=5e5,
    optimizer_moment_dtype="bfloat16",
    remat_policy="full",
    seq_shard_activations=True,
    num_microbatches=16,
    kv_cache_dtype="int8",
)
