"""Nemotron-4 340B — dense, GQA kv=8, squared-ReLU MLP (ungated). [arXiv:2402.16819]

Copy of ``src/repro/configs/nemotron_4_340b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp_act="squared_relu",
    optimizer_moment_dtype="bfloat16",
    remat_policy="full",
    seq_shard_activations=True,
    num_microbatches=16,
    kv_cache_dtype="int8",
)
