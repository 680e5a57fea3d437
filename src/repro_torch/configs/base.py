"""Architecture configuration system.

Every assigned architecture is expressed as an ``ArchConfig``. The model code in
``repro_torch.models`` is driven entirely by this dataclass, so adding an architecture is
config-only. ``reduced()`` produces the CPU smoke-test variant of the same family.

Copy of ``src/repro/configs/base.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds used by the hybrid/SSM families.
ATTN = "attn"           # attention + mlp block
MAMBA1 = "mamba1"       # Mamba-1 block (attention-free)
MAMBA2 = "mamba2"       # Mamba-2 (SSD) block
SHARED_ATTN = "shared_attn"  # zamba2: shared-weight attention block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for GShard-style dispatch (tokens per expert =
    # capacity_factor * tokens * top_k / num_experts)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int          # N: per-channel state size
    conv_width: int = 4
    expand: int = 2         # d_inner = expand * d_model
    headdim: int = 64       # mamba2 head dim (P)
    chunk: int = 256        # mamba2 SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Attention options
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full attention
    local_global_alternate: bool = False  # gemma2: even layers local, odd global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # MLP
    mlp_act: str = "silu_gated"      # silu_gated | squared_relu | gelu_gated
    # Hybrid layout (zamba2): one shared attn block applied every k mamba blocks
    hybrid_shared_every: int = 0
    # Embedding frontend stub for [vlm]/[audio]: inputs are precomputed embeddings
    embedding_frontend_stub: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # memory policy (per §5 of DESIGN.md)
    optimizer_moment_dtype: str = "float32"   # bf16 for >=100B archs
    remat_policy: str = "nothing"             # nothing | dots | full
    # gradient-accumulation microbatches for the production train step (the
    # live activation set shrinks by this factor; SSM archs use this instead
    # of sequence-sharded activations, which fight the seq-dim scan)
    num_microbatches: int = 1
    # KV-cache storage dtype for decode ("bfloat16" | "int8"). int8 stores
    # per-(position, head) absmax scales alongside and dequantizes at the
    # attention read — halves the decode-task HBM footprint, which doubles
    # how many decode jobs the paper's scheduler can pack per chip
    kv_cache_dtype: str = "bfloat16"
    # Megatron-style sequence parallelism for the residual stream: the carry
    # between layers is sharded [batch->data, seq->model], so the remat-saved
    # activation stack shrinks by the model-axis size (all-gather at layer
    # entry / reduce-scatter at exit, inserted by GSPMD).
    seq_shard_activations: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the full stack."""
        if self.family == "ssm":
            return (MAMBA1,) * self.n_layers
        if self.family == "hybrid":
            kinds = []
            k = self.hybrid_shared_every or 6
            for i in range(self.n_layers):
                kinds.append(SHARED_ATTN if (i % k == k - 1) else MAMBA2)
            return tuple(kinds)
        return (ATTN,) * self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim if self.n_heads else 0
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds():
            if kind == ATTN:
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                    + (self.n_heads * hd) * d
                if self.moe is not None:
                    mlp = self.moe.num_experts * self.mlp_params_per_expert() \
                        + d * self.moe.num_experts  # router
                else:
                    mlp = self.mlp_params_per_expert()
                total += attn + mlp + 2 * d
            elif kind in (MAMBA1, MAMBA2):
                assert self.ssm is not None
                e = self.ssm.expand * d
                n = self.ssm.state_dim
                if kind == MAMBA1:
                    # in_proj (2e), conv, x_proj(dt,B,C), dt_proj, out_proj, A, D
                    total += d * 2 * e + e * self.ssm.conv_width \
                        + e * (n * 2 + e // 16) + (e // 16) * e + e * d + e * n + e
                else:
                    nh = e // self.ssm.headdim
                    total += d * (2 * e + 2 * n + nh) + e * self.ssm.conv_width \
                        + e * d + 2 * nh
                total += d
            elif kind == SHARED_ATTN:
                total += 2 * d  # norms only; weights shared (counted once below)
        if self.family == "hybrid":
            hd2 = self.resolved_head_dim
            total += self.d_model * (self.n_heads * hd2) * 2 \
                + 2 * self.d_model * (self.n_kv_heads * hd2) \
                + self.mlp_params_per_expert()
        return total

    def mlp_params_per_expert(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.mlp_act.endswith("gated"):
            return 3 * d * f
        return 2 * d * f

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        inactive = (self.moe.num_experts - self.moe.top_k) * \
            self.mlp_params_per_expert() * self.n_layers
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 6),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            moe=None if self.moe is None else dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2)),
            ssm=None if self.ssm is None else dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16), headdim=32,
                chunk=32),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            hybrid_shared_every=3 if self.hybrid_shared_every else 0,
            optimizer_moment_dtype="float32",
            remat_policy="nothing",
            num_microbatches=1,
            seq_shard_activations=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
