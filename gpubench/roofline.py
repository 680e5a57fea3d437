"""The benchmark's frozen yardstick: the card's published peaks, the bounds
of the port's kernels, and the model FLOPs of served tokens.

Copied from the port's own arithmetic and frozen here, so that a later
change to the program cannot move the yardstick it is measured by:

  * the kernels' bounds are ``chip_smoke.py``'s: each input read once and
    each output written once at the card's bandwidth, or the operations at
    the dtype's peak, whichever takes longer;
  * the model FLOPs are the matrix products of ``launch/flops.py``'s SSM
    and attention terms; its "scan elementwise" term is left out, so a
    token's FLOPs are what a matmul unit would have to do.

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity.
"""
from __future__ import annotations

from typing import Mapping, Sequence

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BW = 3.35e12  # bytes/s

ELEMENT_BYTES = {"float": 4, "float32": 4, "c10::BFloat16": 2,
                 "bfloat16": 2, "c10::Half": 2, "half": 2}


def _bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / H100_HBM_BW, flops / peak)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def scan_bound_s(shape: Sequence[int]) -> float:
    """The selective scan over a, b of ``shape`` [B, S, E, N] in f32: a and
    b read once, every state h written once, the last state written once;
    two operations an element at the f32 peak."""
    n = _numel(shape)
    last = n // int(shape[1]) if len(shape) > 1 and shape[1] else 0
    return _bound_s(3 * n * 4 + last * 4, 2 * n, H100_F32_FLOPS)


def rmsnorm_bound_s(shape: Sequence[int], element_bytes: int) -> float:
    """RMSNorm of x ``shape`` [..., d]: x read and written once, the scale
    read once; four operations an element at the f32 peak."""
    n = _numel(shape)
    d = int(shape[-1])
    return _bound_s(2 * n * element_bytes + d * element_bytes, 4 * n,
                    H100_F32_FLOPS)


# ---------------------------------------------------------------------------
# Model FLOPs (matrix products only)
# ---------------------------------------------------------------------------

def _attn_flops(c: Mapping, tokens: int, kv_len: float) -> float:
    d, hd = c["d_model"], c["head_dim"]
    hq, hkv = c["n_heads"], c["n_kv_heads"]
    proj = 2 * tokens * d * (hq + 2 * hkv) * hd + 2 * tokens * hq * hd * d
    return proj + 2 * 2 * tokens * kv_len * hq * hd


def _mlp_flops(c: Mapping, tokens: int) -> float:
    mults = 3 if c["mlp_act"].endswith("gated") else 2
    return 2.0 * tokens * c["d_model"] * c["d_ff"] * mults


def _mamba1_flops(c: Mapping, tokens: int) -> float:
    d = c["d_model"]
    e, n = c["expand"] * d, c["state_dim"]
    r = max(1, d // 16)
    return float(tokens) * (2 * d * 2 * e + 2 * e * c["conv_width"]
                            + 2 * e * (r + 2 * n) + 2 * r * e
                            + 2 * e * n + 2 * e * d)


def _mamba2_flops(c: Mapping, tokens: int, *, chunked: bool) -> float:
    d = c["d_model"]
    e, n = c["expand"] * d, c["state_dim"]
    nh = e // c["headdim"]
    per_tok = (2 * d * (2 * e + 2 * n + nh)
               + 2 * (e + 2 * n) * c["conv_width"]
               + 2 * 2 * e * n + 2 * e * d)
    if chunked:  # the SSD's products within a chunk
        per_tok += 2 * c["chunk"] * n + 2 * c["chunk"] * e
    return float(tokens) * per_tok


def _layers(c: Mapping):
    if c["family"] == "ssm":
        return ["mamba1"] * c["n_layers"]
    k = c["hybrid_shared_every"]
    return ["shared_attn" if i % k == k - 1 else "mamba2"
            for i in range(c["n_layers"])]


def prefill_flops(c: Mapping, seq: int) -> float:
    """One prompt of ``seq`` tokens through the model (the SSD chunked, a
    causal query attending to seq/2 keys on average) and the head of its
    last position, as ``launch/flops.py::forward_flops`` counts a forward
    without the scan's elementwise term."""
    total = 0.0
    for kind in _layers(c):
        if kind == "mamba1":
            total += _mamba1_flops(c, seq)
        elif kind == "mamba2":
            total += _mamba2_flops(c, seq, chunked=True)
        else:
            total += _attn_flops(c, seq, seq / 2.0) + _mlp_flops(c, seq)
    return total + 2.0 * c["d_model"] * c["vocab"]


def decode_flops(c: Mapping, context: int) -> float:
    """One decoded token at ``context`` positions of cache: the recurrent
    step of each state-space layer (no chunk), attention over the whole
    cache, and the head."""
    total = 0.0
    for kind in _layers(c):
        if kind == "mamba1":
            total += _mamba1_flops(c, 1)
        elif kind == "mamba2":
            total += _mamba2_flops(c, 1, chunked=False)
        else:
            total += _attn_flops(c, 1, float(context)) + _mlp_flops(c, 1)
    return total + 2.0 * c["d_model"] * c["vocab"]
