"""DBRX 132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]

Copy of ``src/repro/configs/dbrx_132b.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(num_experts=16, top_k=4),
    mlp_act="silu_gated",
    rope_theta=5e5,
    optimizer_moment_dtype="bfloat16",
    remat_policy="full",
    seq_shard_activations=True,
    num_microbatches=4,
    kv_cache_dtype="int8",
)
