"""State-space blocks in PyTorch: Mamba-1 (selective scan), the layer of
falcon-mamba, and Mamba-2 (SSD, chunked matmul form), the backbone of the
zamba2 hybrid.

Port of ``src/repro/models/ssm.py``. The casts are the reference's: for
Mamba-1 ``dt`` is computed in the parameter dtype, the scan inputs ``a``,
``b`` are built in f32, ``y`` is computed in f32 and cast to x's dtype before
``out_proj``, and the conv state is the tail of the pre-conv, pre-activation
``xs``. For Mamba-2 ``dt + dt_bias`` promotes to f32 (``dt_bias`` is f32),
the SSD runs in f32, ``y`` is cast to x's dtype before the gate and the
gated norm, ``D`` is per head, and the conv state is the pre-activation
``xbc`` tail (E + 2N wide).

Differences from the reference (Mamba-1):

  * the recurrence runs in the hand kernel ``kernels.mamba_scan`` (its plain
    version on CPU tensors), where the reference's model runs a chunked
    associative scan (``_scan_chunked``), so S need not divide any chunk;
  * ``a`` and ``b`` ([B, S, E, N] f32, 2.15 GB each at falcon-mamba-7b's
    prefill shape) are built with in-place ops, so a layer's peak holds a,
    b and the scan's output and no further temporaries of that size;
  * ``mamba1_decode_step`` updates the decode state IN PLACE (the reference
    returns new arrays), so one state stays resident per task.

Mamba-2 (``mamba2_apply``, the reference's ``:141-198``): the SSD's
intra-chunk work stays plain PyTorch einsums, as the reference computes it
outside any Pallas kernel. Differences:

  * the recurrence across chunks (``h_new = h·a_k + s_k``, emitting the
    state entering each chunk: a ``lax.scan`` in the reference) runs in the
    hand scan ``kernels.mamba_scan`` over ``[B, nc, nh·P, N]``, ``a_k``
    broadcast over (P, N); the state entering chunk c is the scan's output
    at c - 1 (zero for the first), the last state the scan's ``h_last``.
    Under autograd the scan's backward kernel differentiates it;
  * the decay matrix masks ``seg`` to -inf above the diagonal before the
    exponential, where the reference takes ``exp(seg)`` over the whole
    square and then selects 0: the same values (``exp(-inf) = 0``), but
    ``seg > 0`` up there overflows to inf at the published chunk (256), and
    the reference's gradient through the selection is ``0·inf`` = NaN;
  * an S that is not a multiple of ``min(chunk, S)`` raises ``ValueError``
    (the reference asserts); a prompt is never padded;
  * ``mamba2_decode_step`` updates its state IN PLACE, as Mamba-1's does.

Under a mesh (DTensor inputs) each block, and each decode step, runs on
each rank's rows with its weights made whole (``dist.sharding.on_rows``),
where the reference shards the channels on ``model``: DTensor on the
card's torch (2.11) cannot pad or reshape split channels. A decode step's
states are gathered on those rows and written back into the cache's
shards.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import replicated_like
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models import layers as L


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``sum_i shift(x, W-1-i) * w[:, i] + b``, summed
    in the reference's order. x: [B, S, C]; w: [C, W]; b: [C]."""
    width, s = w.shape[-1], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(width):
        shift = width - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[:, i]
    return out + b


def _step_on_rows(step, p: dict, x_t: torch.Tensor,
                  state: Dict[str, torch.Tensor], cfg: SSMConfig):
    """A decode ``step`` of DTensors on each rank's rows
    (``dist.sharding.on_rows``): the states, whole on those rows, are
    updated there and written back into the cache's shards."""
    keys = list(state)

    def run(pl, xl, *sts):
        local = dict(zip(keys, sts))
        return (step(pl, xl, local, cfg),) + tuple(local[k] for k in keys)
    out, *sts = SH.on_rows(run, p, x_t, *(state[k] for k in keys))
    for k, v in zip(keys, sts):
        SH.write_into(state[k], v)
    return out


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One decode step. x_t: [B, C]; conv_state: [B, W-1, C], shifted IN
    PLACE to hold the last W-1 inputs (in its own dtype). Returns the conv
    output [B, C]."""
    window = torch.cat([conv_state, x_t[:, None]], 1)  # promotes, as jnp
    out = torch.einsum("bwc,cw->bc", window, w) + b
    conv_state.copy_(window[:, 1:])
    return out


def _split_proj(p: dict, xs: torch.Tensor, n: int):
    """(dt [.., E] in the parameter dtype, B [.., N], C [.., N])."""
    dt_rank = p["dt_proj_w"].shape[0]
    proj = xs @ p["x_proj"]
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj_w"] + p["dt_proj_b"])
    return dt, bmat, cmat


def _gate(p: dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """(y + xs·D)·silu(z) in f32, cast to ``dtype`` before ``out_proj``."""
    y = (y + xs.float() * p["D"]) * F.silu(z).float()
    return y.to(dtype) @ p["out_proj"]


def mamba1_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, *,
                 return_state: bool = False):
    """Mamba-1 block. x: [B, S, d] -> [B, S, d]; with ``return_state`` also
    the decode state ``{"conv": [B, W-1, E], "ssm": [B, E, N] f32}``."""
    if SH.is_dtensor(x):
        return SH.on_rows(lambda pl, xl: mamba1_apply(
            pl, xl, cfg, return_state=return_state), p, x)
    n = cfg.state_dim
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # [B, S, E] each
    conv_tail = xs[:, -(cfg.conv_width - 1):].clone()
    xs = F.silu(causal_conv1d(xs, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _split_proj(p, xs, n)
    a_cont = -torch.exp(p["A_log"].float())  # [E, N]
    # the scan's [B, S, E, N] inputs, each made by one broadcast op and then
    # updated in place
    a = (dt[..., None].float() * a_cont).exp_()
    b = (dt * xs)[..., None].float() * bmat[..., None, :].float()
    h, h_last = mamba_scan(a, b)
    del a, b
    y = torch.matmul(h, cmat.float()[..., None])[..., 0]  # [B, S, E]
    del h
    out = _gate(p, y, xs, z, x.dtype)
    if return_state:
        return out, {"conv": conv_tail, "ssm": h_last}
    return out


def mamba1_decode_step(p: dict, x_t: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       cfg: SSMConfig) -> torch.Tensor:
    """x_t: [B, d]; state: ``{"conv": [B, W-1, E], "ssm": [B, E, N] f32}``,
    both updated IN PLACE. Returns the block output [B, d]."""
    if SH.is_dtensor(x_t):
        return _step_on_rows(mamba1_decode_step, p, x_t, state, cfg)
    n = cfg.state_dim
    xs, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)
    xs = F.silu(conv1d_step(xs, state["conv"], p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _split_proj(p, xs, n)
    a_cont = -torch.exp(p["A_log"].float())
    a = (dt[..., None].float() * a_cont).exp_()  # [B, E, N]
    b = (dt * xs)[..., None].float() * bmat[:, None, :].float()
    h = state["ssm"].mul_(a).add_(b)
    y = torch.matmul(h, cmat.float()[..., None])[..., 0]  # [B, E]
    return _gate(p, y, xs, z, x_t.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked matmul form)
# ---------------------------------------------------------------------------

def _split_m2(p: dict, x: torch.Tensor, cfg: SSMConfig):
    """(z, xbc, dt f32 [.., nh], E, N, nh) of the input projection."""
    e = p["out_proj"].shape[0]
    n = cfg.state_dim
    nh = e // cfg.headdim
    z, xbc, dt = torch.split(x @ p["in_proj"], [e, e + 2 * n, nh], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])  # dt_bias f32: promotes
    return z, xbc, dt, e, n, nh


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``rms_norm(y·silu(z), norm) @ out_proj``, y already in x's dtype."""
    return L.rms_norm(y * F.silu(z), p["norm"]) @ p["out_proj"]


def chunk_recurrence(a_chunk: torch.Tensor, s_c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD's recurrence across chunks, ``h_c = h_{c-1}·a_c + s_c`` from
    a zero state, in the scan kernel: a_chunk [B, nc, nh] (each head's decay
    over its chunk), s_c [B, nc, nh, P, N] f32 (each chunk's own state) ->
    (the state entering each chunk [B, nc, nh, P, N], the last state [B,
    nh, P, N]), the reference's ``lax.scan`` (``ssm.py:179-187``). The
    scan runs over [B, nc, nh·P, N] with ``a`` broadcast over (P, N)."""
    bsz, nc, nh, ph, n = s_c.shape
    a = a_chunk[:, :, :, None, None].expand(bsz, nc, nh, ph, n)
    h_all, h_last = mamba_scan(
        a.reshape(bsz, nc, nh * ph, n).contiguous(),
        s_c.reshape(bsz, nc, nh * ph, n).contiguous())
    h_prev = F.pad(h_all[:, :-1], (0, 0, 0, 0, 1, 0))
    return h_prev.reshape(s_c.shape), h_last.reshape(bsz, nh, ph, n)


def mamba2_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, *,
                 return_state: bool = False):
    """Mamba-2 (SSD) block, chunked. x: [B, S, d] -> [B, S, d]; with
    ``return_state`` also the decode state ``{"conv": [B, W-1, E+2N],
    "ssm": [B, nh, P, N] f32}``."""
    if SH.is_dtensor(x):
        return SH.on_rows(lambda pl, xl: mamba2_apply(
            pl, xl, cfg, return_state=return_state), p, x)
    bsz, s, _ = x.shape
    lc = min(cfg.chunk, s)
    if s % lc:
        raise ValueError(f"Mamba-2: sequence {s} is not a multiple of the "
                         f"chunk {lc}")
    nc = s // lc
    z, xbc, dt, e, n, nh = _split_m2(p, x, cfg)
    conv_tail = xbc[:, -(cfg.conv_width - 1):].clone()
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = torch.split(xbc, [e, n, n], dim=-1)
    ph = cfg.headdim
    xh = xs.reshape(bsz, s, nh, ph)
    log_a = -torch.exp(p["A_log"].float()) * dt.float()  # [B, S, nh]

    xh_c = xh.reshape(bsz, nc, lc, nh, ph)
    b_c = bmat.reshape(bsz, nc, lc, n).float()
    c_c = cmat.reshape(bsz, nc, lc, n).float()
    cum = torch.cumsum(log_a.reshape(bsz, nc, lc, nh), dim=2)
    dtx = dt.reshape(bsz, nc, lc, nh, 1).float() * xh_c.float()

    # intra-chunk (attention-like): masked to -inf before the exponential
    g = torch.einsum("bcln,bcsn->bcls", c_c, b_c)          # [B,nc,Lc,Lc]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Lc,Lc,nh]
    above = replicated_like(
        torch.ones(lc, lc, dtype=torch.bool, device=x.device).triu_(1), x)
    att = seg.masked_fill(above[:, :, None], float("-inf")).exp() \
        * g[..., None]
    del seg
    y = torch.einsum("bclsh,bcshp->bclhp", att, dtx)
    del att

    # each chunk's state contribution; the recurrence across chunks in the
    # scan kernel, over [B, nc, nh·P, N]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # [B,nc,Lc,nh]
    s_c = torch.einsum("bcsn,bcshp->bchpn", b_c,
                       decay_to_end[..., None] * dtx)      # [B,nc,nh,P,N]
    h_prev, h_last = chunk_recurrence(torch.exp(cum[:, :, -1, :]), s_c)
    y_inter = torch.einsum("bcln,bchpn->bclhp", c_c, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y + y_inter).reshape(bsz, s, nh, ph)
    y = y + p["D"][:, None] * xh.float()
    out = _gated_out(p, y.reshape(bsz, s, e).to(x.dtype), z)
    if return_state:
        return out, {"conv": conv_tail, "ssm": h_last}
    return out


def mamba2_decode_step(p: dict, x_t: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       cfg: SSMConfig) -> torch.Tensor:
    """x_t: [B, d]; state: ``{"conv": [B, W-1, E+2N], "ssm": [B, nh, P, N]
    f32}``, both updated IN PLACE. Returns the block output [B, d]."""
    if SH.is_dtensor(x_t):
        return _step_on_rows(mamba2_decode_step, p, x_t, state, cfg)
    bsz = x_t.shape[0]
    z, xbc, dt, e, n, nh = _split_m2(p, x_t, cfg)
    xbc = F.silu(conv1d_step(xbc, state["conv"], p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = torch.split(xbc, [e, n, n], dim=-1)
    xh = xs.reshape(bsz, nh, cfg.headdim).float()
    dt32 = dt.float()
    a = torch.exp(-torch.exp(p["A_log"].float()) * dt32)  # [B, nh]
    dtx = dt32[..., None] * xh                             # [B, nh, P]
    h = state["ssm"].mul_(a[..., None, None]).add_(
        dtx[..., None] * bmat.float()[:, None, None, :])
    y = torch.matmul(h, cmat.float()[:, None, :, None])[..., 0]  # [B,nh,P]
    y = y + p["D"][:, None] * xh
    return _gated_out(p, y.reshape(bsz, e).to(x_t.dtype), z)
