"""Qwen1.5 32B — dense, QKV bias. [hf:Qwen/Qwen1.5-0.5B family]

Copy of ``src/repro/configs/qwen1_5_32b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    mlp_act="silu_gated",
    rope_theta=1e6,
    optimizer_moment_dtype="float32",
    remat_policy="full",
    num_microbatches=4,
    seq_shard_activations=True,
    kv_cache_dtype="int8",
)
