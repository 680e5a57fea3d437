"""InternVL2 76B — VLM; InternLM2 decoder backbone, ViT frontend stubbed.
[arXiv:2404.16821]

Copy of ``src/repro/configs/internvl2_76b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    mlp_act="silu_gated",
    embedding_frontend_stub=True,
    rope_theta=1e6,
    optimizer_moment_dtype="bfloat16",
    remat_policy="full",
    seq_shard_activations=True,
    num_microbatches=4,
    kv_cache_dtype="int8",
)
