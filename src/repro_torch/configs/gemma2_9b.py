"""Gemma-2 9B — local(4096)+global alternating attention, logit softcaps.
[arXiv:2408.00118]

Copy of ``src/repro/configs/gemma2_9b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    sliding_window=4096,
    local_global_alternate=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="gelu_gated",
    tie_embeddings=True,
    optimizer_moment_dtype="float32",
    remat_policy="full",
    seq_shard_activations=True,
    kv_cache_dtype="int8",
)
