"""Analytic FLOPs model per (arch x shape).

XLA's ``cost_analysis()`` counts while-loop bodies ONCE, so its FLOPs number is
useless for scan-over-layers programs (observed: 18x undercount on gemma2). The
roofline compute term therefore uses this analytic model — every matmul in the
model code is accounted, including attention's quadratic term, MoE capacity
padding + dispatch einsums, SSD chunk matmuls, and the remat recompute factor.
HLO raw flops are still recorded for reference.

Copy of ``src/repro/launch/flops.py`` with its imports rewritten to
``repro_torch`` (framework-free); keep the two in step. The port's probes
count traced flops with ``FlopCounterMode``; the NN workloads take this
model's numbers as the reference does (``core/workloads.py``).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig, ATTN, MAMBA1, MAMBA2, \
    SHARED_ATTN
from repro_torch.models.moe import capacity

MOE_GROUP = 512


def _attn_layer_flops(cfg: ArchConfig, s_q: int, kv_len: float) -> float:
    """Forward FLOPs for one attention block over s_q query tokens, each
    attending to ``kv_len`` keys on average."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * s_q * d * (hq + 2 * hkv) * hd + 2 * s_q * hq * hd * d
    attn = 2 * 2 * s_q * kv_len * hq * hd  # QK^T + PV
    return proj + attn


def _mlp_layer_flops(cfg: ArchConfig, tokens: int) -> float:
    mults = 3 if cfg.mlp_act.endswith("gated") else 2
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mults


def _moe_layer_flops(cfg: ArchConfig, tokens: int) -> float:
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    mults = 3 if cfg.mlp_act.endswith("gated") else 2
    cap = capacity(m, MOE_GROUP)
    eff_tokens_per_group = m.num_experts * cap       # incl. capacity padding
    groups = tokens / MOE_GROUP
    expert = 2.0 * groups * eff_tokens_per_group * d * f * mults
    router = 2.0 * tokens * d * m.num_experts
    # dispatch + combine einsums: 2 * g * s * E * C * d each
    dispatch = 2 * 2.0 * groups * MOE_GROUP * m.num_experts * cap * d
    return expert + router + dispatch


def _mamba1_layer_flops(cfg: ArchConfig, tokens: int) -> float:
    d = cfg.d_model
    e = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    r = max(1, d // 16)
    per_tok = (2 * d * 2 * e + 2 * e * cfg.ssm.conv_width
               + 2 * e * (r + 2 * n) + 2 * r * e
               + 9 * e * n          # scan elementwise (assoc-scan ~3 passes)
               + 2 * e * n          # y = h . C
               + 2 * e * d)
    return float(tokens) * per_tok


def _mamba2_layer_flops(cfg: ArchConfig, tokens: int) -> float:
    d = cfg.d_model
    e = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    nh = e // cfg.ssm.headdim
    lc = cfg.ssm.chunk
    per_tok = (2 * d * (2 * e + 2 * n + nh)
               + 2 * (e + 2 * n) * cfg.ssm.conv_width
               + 2 * lc * n            # C B^T within chunk
               + 2 * lc * e            # att @ dtx
               + 2 * 2 * e * n         # chunk states + y_inter
               + 2 * e * d)
    return float(tokens) * per_tok


def forward_flops(cfg: ArchConfig, batch: int, seq: int, *,
                  kv_len: float = None) -> float:
    """One forward pass over batch x seq tokens (kv_len: avg keys/query)."""
    tokens = batch * seq
    total = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in (ATTN, SHARED_ATTN):
            if kv_len is not None:
                kl = kv_len
            else:
                w = cfg.sliding_window
                local = bool(w) and (not cfg.local_global_alternate or i % 2 == 0)
                kl = min(seq / 2.0, w) if local else seq / 2.0  # causal avg
            total += batch * _attn_layer_flops(cfg, seq, kl)
            if kind == ATTN and cfg.moe is not None:
                total += _moe_layer_flops(cfg, tokens)
            else:
                total += _mlp_layer_flops(cfg, tokens)
        elif kind == MAMBA1:
            total += _mamba1_layer_flops(cfg, tokens)
        elif kind == MAMBA2:
            total += _mamba2_layer_flops(cfg, tokens)
    total += 2.0 * tokens * cfg.d_model * cfg.vocab  # lm head
    return total


REMAT_FACTOR = {"nothing": 3.0, "dots": 3.3, "full": 4.0}


def step_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic FLOPs for the step the shape lowers (global, all chips)."""
    if shape.kind == "train":
        fwd = forward_flops(cfg, shape.global_batch, shape.seq_len)
        return fwd * REMAT_FACTOR.get(cfg.remat_policy, 4.0)
    if shape.kind == "prefill":
        return forward_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token; attention reads the whole cache (ring: window)
    kv = cache_kv_len(cfg, shape.seq_len)
    return forward_flops(cfg, shape.global_batch, 1, kv_len=kv)


def cache_kv_len(cfg: ArchConfig, seq_len: int) -> float:
    if cfg.sliding_window and not cfg.local_global_alternate:
        return float(min(seq_len, cfg.sliding_window))
    return float(seq_len)
