"""Decoder model of every family the reference covers: the attention
families (dense, the vlm/audio stacks that feed precomputed embeddings,
and moe: mixtral, dbrx), the Mamba-1 family (ssm: falcon-mamba) and the
zamba2 hybrid (groups of Mamba-2 layers, each group closed by one
attention + MLP block whose weights all groups share), in PyTorch.

Port of ``src/repro/models/model.py``.
Where the reference stacks layer weights on a leading [L] dim and
``lax.scan``s over them, the port keeps a list of per-layer dicts and runs a
Python loop, so ``_layer_window`` returns a plain int per layer and gemma2's
alternating window reaches the attention kernel as a runtime argument. The
hybrid's ``groups`` (stacked [G] and [G, k-1] in the reference) is a list
of G dicts with the reference's keys (``mamba``, ``norm_m``, ``norm_attn``,
``norm_mlp``), whose ``mamba`` and ``norm_m`` are lists of the group's k-1
Mamba-2 layers; ``shared`` (``attn``, ``mlp``) is one plain dict.
Parameters keep the reference's layouts (``wq: [d, h, hd]``, ``wo: [h, hd,
d]``, ``in_proj: [d, 2E]``, experts ``router: [d, E]``, ``wi/wg: [E, d, f]``,
``wo: [E, f, d]``), so ``repro_torch.convert`` moves JAX weights over
unchanged.

``attn_impl`` picks the prefill attention: ``"flash_kernel"`` (the hand CUDA
kernel; its plain version on CPU tensors), ``"flash_plain"`` (chunked
online-softmax in plain PyTorch) or ``"naive"`` (the oracle).

Training (``loss_fn``, ``chunked_softmax_xent``: ``model.py:438-471`` of the
reference) differentiates the same forward: the hand kernels' ops carry
their backward kernels (``repro_torch.kernels``), and under
``remat_policy="full"`` each layer (for the hybrid, each group, as the
reference's ``group_body``) is a non-reentrant
``torch.utils.checkpoint`` whose backward recomputes it (the
reference's ``_remat``, ``:309``), so only the layers' inputs are saved;
under ``"dots"`` the outputs of the layer's matrix products stay saved too
and the rest is recomputed. The hybrid's shared block is used by every
group, so its gradient is the sum of the groups'.
The loss recomputes each 512-position chunk's f32 logits in the backward
instead of saving them. Training runs every family the port serves: the
Mamba scan and the MoE layer's grouped matmuls have backward
kernels too, and the loss adds the MoE aux loss (``aux_weight``, 0.01).
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import (
    constrain, grad_to, in_current_mesh, is_dtensor, replicated,
    replicated_like, write_into,
)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]
FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
# families whose every kernel has a backward
TRAIN_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
XENT_CHUNK = 512
ATTN_IMPLS = ("flash_kernel", "flash_plain", "naive")


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {', '.join(FAMILIES)} families "
            f"(family {cfg.family!r})")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid_shared_every:
        raise ValueError(
            f"{cfg.name}: a hybrid's depth ({cfg.n_layers}) must be a "
            f"multiple of its group ({cfg.hybrid_shared_every} layers)")


def hybrid_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups G, layers k a group) of the hybrid: k-1 Mamba-2 layers and
    the shared attention + MLP block."""
    k = cfg.hybrid_shared_every
    return cfg.n_layers // k, k


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

# f32 elements of one random draw for a weight kept in a narrower dtype: a
# larger one is drawn in slices of its first dim, so the f32 draw beside it
# stays 0.5e9 B (nemotron-4-340b's 256000 x 18432 embedding in one draw
# would hold 18.9e9 B of f32 beside its 9.4e9 B of bf16)
INIT_DRAW = 1 << 27


def _init(gen: torch.Generator, shape, dtype, device, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    row = math.prod(shape[1:])
    if dtype == torch.float32 or len(shape) < 2 or shape[0] * row <= INIT_DRAW:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)
    w = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, INIT_DRAW // row)
    for i in range(0, shape[0], rows):
        part = torch.randn((min(rows, shape[0] - i),) + tuple(shape[1:]),
                           generator=gen, dtype=torch.float32, device=device)
        w[i:i + rows] = part.mul_(scale)
    return w


def _attn_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": _init(gen, (d, h, hd), dtype, device, d ** -0.5),
        "wk": _init(gen, (d, kv, hd), dtype, device, d ** -0.5),
        "wv": _init(gen, (d, kv, hd), dtype, device, d ** -0.5),
        "wo": _init(gen, (h, hd, d), dtype, device, (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h, hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kv, hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kv, hd, dtype=dtype, device=device)
    return p


def _mlp_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _init(gen, (d, f), dtype, device),
         "wo": _init(gen, (f, d), dtype, device)}
    if cfg.mlp_act.endswith("gated"):
        p["wg"] = _init(gen, (d, f), dtype, device)
    return p


def _init_experts(gen: torch.Generator, shape, dtype, device):
    """An [E, fan_in, out] expert stack made one expert at a time, so the
    f32 draw is one expert big (0.23e9 B at mixtral's widths, not 1.9e9)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        w[e] = _init(gen, shape[1:], dtype, device)
    return w


def _moe_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": _init(gen, (d, e), dtype, device),
         "wi": _init_experts(gen, (e, d, f), dtype, device),
         "wo": _init_experts(gen, (e, f, d), dtype, device)}
    if cfg.mlp_act.endswith("gated"):
        p["wg"] = _init_experts(gen, (e, d, f), dtype, device)
    return p


def _mamba1_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    """``A_log`` and ``D`` stay f32 whatever the parameter dtype."""
    d = cfg.d_model
    e, n, w = cfg.ssm.expand * d, cfg.ssm.state_dim, cfg.ssm.conv_width
    r = max(1, d // 16)  # dt_rank
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(e, n).clone()
    return {
        "in_proj": _init(gen, (d, 2 * e), dtype, device),
        "conv_w": _init(gen, (e, w), dtype, device, 0.2),
        "conv_b": torch.zeros(e, dtype=dtype, device=device),
        "x_proj": _init(gen, (e, r + 2 * n), dtype, device),
        "dt_proj_w": _init(gen, (r, e), dtype, device),
        "dt_proj_b": torch.full((e,), -4.0, dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones(e, dtype=torch.float32, device=device),
        "out_proj": _init(gen, (e, d), dtype, device),
    }


def _mamba2_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    """``dt_bias``, ``A_log`` and ``D`` (one per head) stay f32."""
    d = cfg.d_model
    e, n, w = cfg.ssm.expand * d, cfg.ssm.state_dim, cfg.ssm.conv_width
    nh = e // cfg.ssm.headdim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(gen, (d, 2 * e + 2 * n + nh), dtype, device),
        "conv_w": _init(gen, (e + 2 * n, w), dtype, device, 0.2),
        "conv_b": torch.zeros(e + 2 * n, dtype=dtype, device=device),
        "dt_bias": torch.zeros(nh, **f32),
        "A_log": torch.zeros(nh, **f32),
        "D": torch.ones(nh, **f32),
        "norm": torch.zeros(e, dtype=dtype, device=device),
        "out_proj": _init(gen, (e, d), dtype, device),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                param_dtype: torch.dtype = torch.float32,
                device=None) -> Params:
    """Random weights at the reference's scales (the numbers differ: torch's
    generator is not JAX's; tests move JAX weights over with ``convert``).
    ``device`` must match the generator's device."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab
    zeros = dict(dtype=param_dtype, device=device)
    params: Params = {"embed": _init(generator, (v, d), param_dtype, device,
                                     1.0)}
    if cfg.family == "hybrid":
        g, k = hybrid_groups(cfg)
        params["groups"] = [
            {"mamba": [_mamba2_params(generator, cfg, param_dtype, device)
                       for _ in range(k - 1)],
             "norm_m": [torch.zeros(d, **zeros) for _ in range(k - 1)],
             "norm_attn": torch.zeros(d, **zeros),
             "norm_mlp": torch.zeros(d, **zeros)}
            for _ in range(g)]
        params["shared"] = {
            "attn": _attn_params(generator, cfg, param_dtype, device),
            "mlp": _mlp_params(generator, cfg, param_dtype, device)}
    elif cfg.family == "ssm":
        params["layers"] = [
            {"norm": torch.zeros(d, **zeros),
             "mamba": _mamba1_params(generator, cfg, param_dtype, device)}
            for _ in range(cfg.n_layers)]
    else:
        ffn, ffn_params = ("moe", _moe_params) if cfg.moe is not None \
            else ("mlp", _mlp_params)
        params["layers"] = [
            {"norm1": torch.zeros(d, **zeros),
             "norm2": torch.zeros(d, **zeros),
             "attn": _attn_params(generator, cfg, param_dtype, device),
             ffn: ffn_params(generator, cfg, param_dtype, device)}
            for _ in range(cfg.n_layers)]
    params["final_norm"] = torch.zeros(d, **zeros)
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (d, v), param_dtype, device)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, h, k] -> [B, h, S, k], the reference's einsum.
    Under a mesh whose ``model`` axis does not divide h (gemma2-9b's 8 KV
    heads, qwen1.5-32b's 40 heads on a 16-wide axis) the heads are
    replicated there and each rank multiplies its own rows by w made whole
    (``_einsum_heads``): DTensor would split the einsum's flattened h·k on
    ``model`` and then cannot unflatten it, in the forward or in the
    gradient."""
    return _einsum_heads("bsd,dhk->bhsk", x, w, w.shape[1])


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o [B, h, S, k] @ w [h, k, d] -> [B, S, d], as ``_heads``."""
    return _einsum_heads("bhsk,hkd->bsd", o, w, w.shape[0])


def _einsum_heads(eq: str, x: torch.Tensor, w: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """``torch.einsum(eq, x, w)``; on each rank's rows with w whole
    (``dist.sharding.on_rows``) under a mesh whose ``model`` axis does
    not divide ``heads``."""
    if is_dtensor(x) and heads % SH.abstract(x.device_mesh).shape.get(
            "model", 1):
        return SH.on_rows(lambda wl, xl: torch.einsum(eq, xl, wl), w, x)
    return torch.einsum(eq, x, w)


def _project_qkv(p: Params, x: torch.Tensor):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    # pin heads on `model` so the seq-sharded residual's S->model sharding
    # does not leak into attention (it forces unsharded w[qkv] gradients)
    q = constrain(q, "batch", "model", None, None)
    k = constrain(k, "batch", "model", None, None)
    v = constrain(v, "batch", "model", None, None)
    return q, k, v


def attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
               positions: torch.Tensor, window: int, attn_impl: str,
               return_kv: bool = False):
    """Full-sequence attention (train/prefill). x: [B, S, d]."""
    q, k, v = _project_qkv(p, x)
    q = L.apply_rope(q, positions[None, None, :], cfg.rope_theta)
    k = L.apply_rope(k, positions[None, None, :], cfg.rope_theta)
    kwargs = dict(causal=True, window=window,
                  logit_softcap=cfg.attn_logit_softcap)
    if attn_impl == "flash_kernel":
        o = L.flash_attention(q, k, v, **kwargs)
    elif attn_impl == "flash_plain":
        o = L.flash_attention_plain(q, k, v, **kwargs)
    elif attn_impl == "naive":
        o = L.naive_attention(q, k, v, **kwargs)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    out = _heads_out(o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attn_decode_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                      pos, kcache: torch.Tensor, vcache: torch.Tensor,
                      window: int, ring: bool = False,
                      kscale: Optional[torch.Tensor] = None,
                      vscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention. x: [B, 1, d]; caches: [B, Hkv, Smax, D] (int8
    with per-(position, head) scales when ``kscale``/``vscale`` are given).

    ``pos`` is an int tensor on the card, 0-d (the whole batch at one
    position) or [B] (continuous batching: each row at its own position);
    nothing reads it on the host, so the step can be captured in a CUDA
    graph and replayed with the positions advanced in place. The new
    token's K/V are written INTO the caches in place (the reference returns
    updated copies; the port updates in place to keep one cache resident)
    at each row's slot ``min(pos, Smax - 1)``, or for a ``ring`` cache (pure
    sliding-window archs, Smax = the window) ``pos % Smax``, where the
    overwrite enforces the window and no window mask is applied: one
    indexed scatter, the reference's one-hot ``where`` without rewriting
    the whole cache. Caches that are DTensors (under a mesh, placed by
    ``cache_specs``) are written and read shard by shard
    (``_decode_sharded``). Returns the attention output [B, 1, d]."""
    q, k, v = _project_qkv(p, x)  # [B, H, 1, hd]
    caches = (kcache, vcache, kscale, vscale)
    if is_dtensor(kcache):
        o = _decode_sharded(q, k, v, pos, caches, cfg, window, ring)
    else:
        o = _decode_local(q, k, v, pos, caches, cfg, window, ring,
                          kcache.shape[2])
    return _heads_out(o, p["wo"])


def _decode_local(q, k, v, pos, caches, cfg: ArchConfig, window: int,
                  ring: bool, smax: int, offset: int = 0, seq_reduce=None):
    """``attn_decode_block``'s cache write and attention on plain tensors:
    the caches hold slots [offset, offset + their depth) of ``smax``; a
    row whose slot lies outside writes nothing (``where`` over the slot it
    reads back, so every rank runs the same ops, shapes static). The
    softmax spans the ranks that split the sequence through
    ``seq_reduce`` (``layers.decode_attention``)."""
    kcache, vcache, kscale, vscale = caches
    b, depth = q.shape[0], kcache.shape[2]
    posv = pos.reshape(-1).expand(b)
    slot = (posv % smax if ring else posv.clamp(max=smax - 1)).long()
    cache_len = (posv + 1).clamp(max=smax)
    q = L.apply_rope(q, posv[:, None, None], cfg.rope_theta)
    k = L.apply_rope(k, posv[:, None, None], cfg.rope_theta)
    window = 0 if ring else window
    split = depth != smax
    if split:
        inside = (slot >= offset) & (slot < offset + depth)
        slot = (slot - offset).clamp(0, depth - 1)
    at = (torch.arange(b, device=q.device), slice(None), slot)

    def put(cache, new):
        if split:
            keep = inside.reshape((b,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, cache[at])
        cache[at] = new

    kw = dict(window=window, logit_softcap=cfg.attn_logit_softcap,
              k_offset=offset, seq_reduce=seq_reduce)
    if kscale is not None:
        k_q, k_s = L.quantize_kv(k, kscale.dtype)
        v_q, v_s = L.quantize_kv(v, vscale.dtype)
        put(kcache, k_q[:, :, 0])
        put(vcache, v_q[:, :, 0])
        put(kscale, k_s[:, :, 0])
        put(vscale, v_s[:, :, 0])
        return L.decode_attention_q8(q, kcache, kscale, vcache, vscale,
                                     cache_len, **kw)
    put(kcache, k[:, :, 0].to(kcache.dtype))
    put(vcache, v[:, :, 0].to(vcache.dtype))
    return L.decode_attention(q, kcache, vcache, cache_len, **kw)


def _decode_sharded(q, k, v, pos, caches, cfg: ArchConfig, window: int,
                    ring: bool) -> torch.Tensor:
    """``attn_decode_block`` over DTensor caches [B, Hkv, Smax, D] (each a
    layer of a stack placed by ``cache_specs``): q, k and v are brought to
    the caches' batch and head placements, replicated along the mesh axes
    that split the cache's sequence (``context_parallel``), and each rank
    writes and attends over its own shard as plain tensors
    (``_decode_local``), at its own slot offset. Where the sequence is
    split, the ranks' partial attentions are merged with their softmax
    statistics (``layers.decode_attention``'s ``seq_reduce``): only [B,
    H]-sized statistics and [B, H, 1, D] partial outputs cross ranks,
    never the cache."""
    from torch.distributed.tensor import Replicate, Shard
    kcache = caches[0]
    mesh = kcache.device_mesh
    want = [pl if isinstance(pl, Shard) and pl.dim in (0, 1) else Replicate()
            for pl in kcache.placements]
    seq_dims = [i for i, pl in enumerate(kcache.placements)
                if isinstance(pl, Shard) and pl.dim == 2]
    q, k, v = (t.redistribute(mesh, want).to_local() for t in (q, k, v))
    _, off = SH.local_shape_and_offset(kcache.shape, mesh,
                                       kcache.placements)
    if is_dtensor(pos):
        pos = pos.full_tensor()
    if pos.dim() and pos.shape[0] == kcache.shape[0] > q.shape[0]:
        pos = pos[off[0]:off[0] + q.shape[0]]  # this rank's rows
    local = tuple(c.to_local() if c is not None else None for c in caches)
    o = _decode_local(q, k, v, pos, local, cfg, window, ring,
                      kcache.shape[2], off[2],
                      _seq_allreduce(mesh, seq_dims) if seq_dims else None)
    return SH.placed(o, mesh, want, _global_shape(o.shape, mesh, want))


def _seq_allreduce(mesh, dims):
    """``t, op -> t`` all-reduced (``op`` "max" or "sum") over the mesh
    dims ``dims``, those that split a cache's sequence."""
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op):
        for d in dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return t
    return reduce


def _global_shape(local, mesh, placements) -> tuple:
    """The global shape of an even shard ``local`` under ``placements``."""
    from torch.distributed.tensor import Shard
    out = list(local)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out[pl.dim] *= mesh.size(i)
    return tuple(out)


def _layer_window(cfg: ArchConfig, layer_idx: int) -> int:
    """Per-layer sliding window (gemma2 alternates local/global)."""
    if not cfg.sliding_window:
        return 0
    if cfg.local_global_alternate:
        return cfg.sliding_window if layer_idx % 2 == 0 else 0
    return cfg.sliding_window


def _seq_axis(cfg: ArchConfig):
    """The residual's sequence dim: on ``model`` where the config shards
    activations by sequence (reference ``seq_ax``), else replicated."""
    return "model" if cfg.seq_shard_activations else None


def _gathered(h: torch.Tensor) -> torch.Tensor:
    """A block's normed input with its sequence whole: where the residual
    is sequence-sharded on ``model`` it is all-gathered at the block's
    entry, and the block's output is reduce-scattered back by the residual
    add (Megatron sequence parallelism, as the reference's config states
    it). A product over a residual split on two mesh dims would flatten
    [B, S] split on both, which DTensor refuses on torch 2.11."""
    return constrain(h, "batch", None, None)


def _block_out(y: torch.Tensor) -> torch.Tensor:
    """A block's output on its way into the residual: the gradient handed
    back to the block is brought to its rows, the sequence whole
    (``dist.sharding.grad_to``; where the residual is sequence-sharded,
    Megatron's all-gather of the backward), so the block's products see
    their rows whole: DTensor may otherwise hand it back split along the
    sequence, which a product's backward cannot flatten with the batch on
    torch 2.11."""
    return grad_to(y, "batch", None, None)


def _attn_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, i: int,
                positions: torch.Tensor, attn_impl: str,
                cache: Optional[Dict[str, torch.Tensor]]):
    """One attention layer: x + attn(norm1(x)), then + ffn(norm2(.)).
    Returns (x, the MoE aux loss or None); writes layer i's K, V into
    ``cache`` when given (prefill)."""
    x = constrain(x, "batch", _seq_axis(cfg), None)
    a, (k, v) = attn_block(lp["attn"], _gathered(L.rms_norm(x, lp["norm1"])),
                           cfg, positions=positions,
                           window=_layer_window(cfg, i), attn_impl=attn_impl,
                           return_kv=True)
    if cache is not None:
        write_into(cache["k"][i], k)
        write_into(cache["v"][i], v)
    del k, v
    x = x + _block_out(a)
    hn = _gathered(L.rms_norm(x, lp["norm2"]))
    if cfg.moe is not None:
        m, aux_l = MOE.moe_apply(lp["moe"], hn, cfg.moe, cfg.mlp_act)
    else:
        m, aux_l = L.mlp_apply(lp["mlp"], hn, cfg.mlp_act), None
    return x + _block_out(m), aux_l


def _ssm_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig,
               return_state: bool):
    """One Mamba-1 layer: x + mamba(norm(x)), and with ``return_state``
    its decode state (prefill), else None."""
    x = constrain(x, "batch", _seq_axis(cfg), None)
    out = SSM.mamba1_apply(lp["mamba"], L.rms_norm(x, lp["norm"]), cfg.ssm,
                           return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out, None


def _hybrid_group(gp: Params, shared: Params, x: torch.Tensor,
                  cfg: ArchConfig, gi: int, positions: torch.Tensor,
                  attn_impl: str, cache: Optional[Dict[str, torch.Tensor]]):
    """One hybrid group (the reference's ``group_body``): k-1 Mamba-2
    layers ``x + mamba2(norm_m(x))``, then the shared block ``x +
    attn(norm_attn(x))``, ``+ mlp(norm_mlp(.))``. Writes group ``gi``'s
    Mamba-2 states and K, V into ``cache`` when given (prefill)."""
    x = constrain(x, "batch", _seq_axis(cfg), None)
    for j, (mp, nm) in enumerate(zip(gp["mamba"], gp["norm_m"])):
        out = SSM.mamba2_apply(mp, L.rms_norm(x, nm), cfg.ssm,
                               return_state=cache is not None)
        if cache is not None:
            out, st = out
            write_into(cache["m_conv"][gi, j], st["conv"])
            write_into(cache["m_ssm"][gi, j], st["ssm"])
            del st
        x = x + out
    a, (k, v) = attn_block(shared["attn"], L.rms_norm(x, gp["norm_attn"]),
                           cfg, positions=positions,
                           window=cfg.sliding_window, attn_impl=attn_impl,
                           return_kv=True)
    if cache is not None:
        write_into(cache["k"][gi], k)
        write_into(cache["v"][gi], v)
    del k, v
    x = x + _block_out(a)
    return x + _block_out(L.mlp_apply(shared["mlp"],
                                      L.rms_norm(x, gp["norm_mlp"]),
                                      cfg.mlp_act))


# the matrix products without batch dims, which "dots" saves: JAX's
# ``checkpoint_dots_with_no_batch_dims`` saves every ``dot_general`` that
# has no batch dimension, and a projection's ``einsum`` or ``@`` over
# [B, S, d] reaches PyTorch's dispatcher as one of these on the rows
# folded together
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for "dots": save the outputs of
    matrix products without batch dims (and a batched product over a
    batch of one, which is the same product), recompute everything else,
    the hand kernels' ops (flash attention, the grouped matmul, the scan,
    RMSNorm) among them."""
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """The reference's ``_remat`` (``model.py:309``): ``"nothing"`` saves
    every activation; ``"full"`` checkpoints the layer (non-reentrant: the
    backward reruns its forward, hand kernels included, and only the
    layer's inputs stay saved); ``"dots"`` checkpoints it selectively
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``): the
    outputs of its matrix products without batch dims stay saved and the
    rest is recomputed (``_dots_policy``), as the reference's
    ``checkpoint_dots_with_no_batch_dims``. No randomness runs in a layer,
    so no RNG state is stashed. The recompute runs under the activation
    mesh of the forward (``in_current_mesh``): on a card autograd runs it
    on a thread of its own."""
    if policy == "nothing":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(in_current_mesh(fn), *args,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            in_current_mesh(fn), *args, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r}")


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tokens' embeddings (or a frontend's ``embeds``), scaled as the
    config asks: a gather whose backward sums repeated tokens in a fixed
    order (indexing's accumulating backward does not, on the CPU). Under a
    mesh (``lookup_rows``) the gather runs on this rank's rows against the
    table made whole (``loss_fn`` makes it whole once for the train step;
    the reference's vocab-parallel gather is where its sharded step fails,
    ROADMAP C2)."""
    if cfg.embedding_frontend_stub and "embeds" in batch:
        x = batch["embeds"]  # modality frontend stub: precomputed embeddings
    else:
        x = lookup_rows(params["embed"], batch["tokens"])
    return scale_embedding(cfg, x)


def lookup_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as ``F.embedding``. Under a mesh (DTensor tokens,
    or a DTensor table) each rank looks up its own tokens in the table made
    whole (the vocab-parallel gather fails under a batch-sharded index,
    ROADMAP C18), and the rows come back placed as the tokens are."""
    if not is_dtensor(tokens) and not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor
    if not is_dtensor(tokens):
        tokens = constrain(replicated_like(tokens, table), "batch",
                           *(None,) * (tokens.dim() - 1))
    if is_dtensor(table):
        table = replicated(table).to_local()
    return DTensor.from_local(F.embedding(tokens.to_local(), table),
                              tokens.device_mesh, tokens.placements,
                              run_check=False)


def _cache_buffers(cfg: ArchConfig, x: torch.Tensor, shapes: dict) -> dict:
    """Uninitialised cache stacks {name: (shape, dtype)} on x's device; a
    DTensor x (under a mesh) gets DTensors placed by ``cache_specs``, each
    rank allocating its own shard (the reference pins the prefill's
    output cache so, ``launch/dryrun.py:82-85``)."""
    if not is_dtensor(x):
        return {k: torch.empty(shp, dtype=dt, device=x.device)
                for k, (shp, dt) in shapes.items()}
    mesh = x.device_mesh
    # shapes only: a tensor made here, even on the meta device, would be
    # counted as a cache-sized allocation by the dry run
    # (``launch/dryrun.py``)
    specs = SH.cache_specs(cfg, {k: SimpleNamespace(shape=shp)
                                 for k, (shp, _) in shapes.items()}, mesh)
    return {k: SH.empty_placed(shp, dt, specs[k], mesh)
            for k, (shp, dt) in shapes.items()}


def scale_embedding(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma2 multiplies the embedding by sqrt(d_model), rounded to x's
    dtype first as the reference does. The factor is a host scalar: a
    tensor made on the card from a Python number would be a blocking copy,
    stalling the host once per step."""
    if cfg.name.startswith("gemma2"):
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def logits_from_hidden(cfg: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).float(), cfg.final_logit_softcap)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "flash_kernel", collect_cache: bool = False):
    """Full-sequence forward. Returns (hidden [B, S, d], the MoE aux loss
    summed over layers, 0 without experts) — plus
    the decode cache when ``collect_cache`` (prefill): the KV cache
    ``{"k", "v": [L, B, Hkv, S, hd]}``, for the ssm family the states
    ``{"conv": [L, B, W-1, E], "ssm": [L, B, E, N] f32}``, for the hybrid
    ``{"m_conv": [G, k-1, B, W-1, E+2N], "m_ssm": [G, k-1, B, nh, P, N]
    f32, "k", "v": [G, B, Hkv, S, hd]}``. The cache is
    written layer by layer into preallocated stacks, so no second copy of
    it is ever live; under a mesh the stacks are DTensors placed by
    ``cache_specs`` (``_cache_buffers``), each rank holding its shard."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, batch)
    x = constrain(x, "batch", None, None)  # pin batch->data in the residual
    bsz, s, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: Optional[Dict[str, torch.Tensor]] = None
    # under autograd each layer is rematerialised per the config
    grad = torch.is_grad_enabled() and x.requires_grad
    if cfg.family == "ssm":
        if collect_cache:
            conv, ssm = ssm_state_shapes(cfg, bsz)
            cache = _cache_buffers(cfg, x, {"conv": (conv, x.dtype),
                                            "ssm": (ssm, torch.float32)})
        body = _remat(_ssm_layer, cfg.remat_policy) if grad else _ssm_layer
        for i, lp in enumerate(params["layers"]):
            x, st = body(lp, x, cfg, cache is not None)
            if cache is not None:
                write_into(cache["conv"][i], st["conv"])
                write_into(cache["ssm"][i], st["ssm"])
            del st
    elif cfg.family == "hybrid":
        positions = torch.arange(s, device=x.device)
        if collect_cache:
            conv, ssm = hybrid_state_shapes(cfg, bsz)
            shape = kv_shape(cfg, bsz, s)
            cache = _cache_buffers(cfg, x, {
                "m_conv": (conv, x.dtype), "m_ssm": (ssm, torch.float32),
                "k": (shape, x.dtype), "v": (shape, x.dtype)})
        body = _remat(_hybrid_group, cfg.remat_policy) if grad \
            else _hybrid_group
        for gi, gp in enumerate(params["groups"]):
            x = body(gp, params["shared"], x, cfg, gi, positions, attn_impl,
                     cache)
    else:
        positions = torch.arange(s, device=x.device)
        if collect_cache:
            shape = kv_shape(cfg, bsz, s)
            cache = _cache_buffers(cfg, x, {"k": (shape, x.dtype),
                                            "v": (shape, x.dtype)})
        body = _remat(_attn_layer, cfg.remat_policy) if grad \
            else _attn_layer
        for i, lp in enumerate(params["layers"]):
            x, aux_l = body(lp, x, cfg, i, positions, attn_impl, cache)
            if aux_l is not None:
                aux = aux + aux_l
    x = L.rms_norm(x, params["final_norm"])
    if collect_cache:
        return x, aux, cache
    return x, aux


def ssm_state_shapes(cfg: ArchConfig, batch: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the stacked Mamba-1 decode states: conv [L, B, W-1, E] and
    ssm [L, B, E, N]."""
    e = cfg.ssm.expand * cfg.d_model
    return ((cfg.n_layers, batch, cfg.ssm.conv_width - 1, e),
            (cfg.n_layers, batch, e, cfg.ssm.state_dim))


def hybrid_state_shapes(cfg: ArchConfig, batch: int
                        ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the hybrid's stacked Mamba-2 decode states: conv [G, k-1,
    B, W-1, E+2N] and ssm [G, k-1, B, nh, P, N]."""
    g, k = hybrid_groups(cfg)
    e, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    return ((g, k - 1, batch, cfg.ssm.conv_width - 1, e + 2 * n),
            (g, k - 1, batch, e // cfg.ssm.headdim, cfg.ssm.headdim, n))


def kv_shape(cfg: ArchConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """Shape of one stacked KV cache tensor: [L, B, Hkv, S, hd], or the
    hybrid's [G, B, Hkv, S, hd] (one shared block a group)."""
    layers = hybrid_groups(cfg)[0] if cfg.family == "hybrid" \
        else cfg.n_layers
    return (layers, batch, cfg.n_kv_heads, seq, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _xent_chunk(cfg: ArchConfig, params: Params, h: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk: [B, chunk, V] f32
    logits, their log-sum-exp minus the gold logit."""
    logits = logits_from_hidden(cfg, params, h)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def _xent_sum(cfg: ArchConfig, params: Params, hidden: torch.Tensor,
              labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """The summed cross-entropy over the sequence in chunks of ``chunk``
    positions, each chunk checkpointed under autograd."""
    s = hidden.shape[1]
    grad = torch.is_grad_enabled() and hidden.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        h, y = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        if grad:
            part = checkpoint(_xent_chunk, cfg, params, h, y,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _xent_chunk(cfg, params, h, y)
        tot = tot + part
    return tot


def _row_sums(x: torch.Tensor) -> list:
    """Placements of a sum over a DTensor's local rows: partial across the
    mesh dims that split the rows, replicated across the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in x.placements]


def _head_name(cfg: ArchConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def _whole_on_rank(x: torch.Tensor, rows: list) -> torch.Tensor:
    """A DTensor table whole, as this rank's plain tensor, whose gradient
    (from this rank's rows) is a partial sum across ``rows``; its
    gradients from several uses sum in it in place (autograd sums a
    DTensor's gradients out of place)."""
    return replicated(x).to_local(grad_placements=rows)


def _xent_sum_on_local_rows(cfg: ArchConfig, params: Params,
                            hidden: torch.Tensor, labels: torch.Tensor,
                            chunk: int) -> torch.Tensor:
    """``_xent_sum`` of DTensors: each rank sums its own rows (the batch's
    shard, the sequence whole) against the head made whole, as plain
    tensors, and the sums add up across the data ranks (a partial sum).
    The head is one plain tensor for all the chunks, so their gradients
    accumulate in it in place."""
    from torch.distributed.tensor import DTensor
    hidden = constrain(hidden, "batch", None, None)
    labels = constrain(replicated_like(labels, hidden), "batch", None)
    rows = _row_sums(hidden)
    name = _head_name(cfg)
    local = dict(params)
    if is_dtensor(params[name]):
        local[name] = _whole_on_rank(params[name], rows)
    tot = _xent_sum(cfg, local, hidden.to_local(), labels.to_local(), chunk)
    return DTensor.from_local(tot, hidden.device_mesh, rows, run_check=False)


def chunked_softmax_xent(cfg: ArchConfig, params: Params,
                         hidden: torch.Tensor, labels: torch.Tensor,
                         chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Mean next-token cross-entropy without keeping [B, S, V] logits: the
    sequence in chunks of ``chunk`` positions, each chunk's f32 logits
    recomputed in the backward (a non-reentrant checkpoint) instead of
    saved (2.1e9 B a chunk at vocab 256000 and batch 4). Port of the
    reference's ``chunked_softmax_xent`` (``model.py:438``). Under a mesh
    each rank computes its own rows' logits with the head whole
    (``_xent_sum_on_local_rows``), where the reference pins the logits
    vocab-parallel on ``model`` (``model.py:455``)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    if is_dtensor(hidden):
        tot = _xent_sum_on_local_rows(cfg, params, hidden, labels, chunk)
    else:
        tot = _xent_sum(cfg, params, hidden, labels, chunk)
    return tot / (b * s)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "flash_kernel",
            aux_weight: float = 0.01) -> torch.Tensor:
    """The training loss: chunked cross-entropy + ``aux_weight`` x the MoE
    aux loss (reference ``loss_fn``, ``model.py:467``). Under a mesh the
    embedding table (and an untied head) is made whole once, as this
    rank's plain tensor, for the gather and the head alike: a tied table's
    two gradients then sum in it in place (DTensor's out-of-place sum of
    them cost 3.36e9 B at gemma2-9b's step on one card)."""
    if is_dtensor(params["embed"]) and "tokens" in batch:
        tokens = constrain(replicated_like(batch["tokens"], params["embed"]),
                           "batch", None)
        batch = {**batch, "tokens": tokens}
        rows = _row_sums(tokens)
        params = dict(params)
        # one order on every rank: each table is gathered by a collective
        for name in dict.fromkeys(("embed", _head_name(cfg))):
            params[name] = _whole_on_rank(params[name], rows)
    hidden, aux = forward(params, cfg, batch, attn_impl=attn_impl)
    ce = chunked_softmax_xent(cfg, params, hidden, batch["labels"])
    return ce + aux_weight * aux
