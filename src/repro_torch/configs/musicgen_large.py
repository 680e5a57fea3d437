"""MusicGen-large — decoder-only over EnCodec tokens; frame-embedding frontend stub.
[arXiv:2306.05284]

Copy of ``src/repro/configs/musicgen_large.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    mlp_act="gelu_gated",
    embedding_frontend_stub=True,
    optimizer_moment_dtype="float32",
    remat_policy="full",
    seq_shard_activations=True,
    kv_cache_dtype="int8",
)
