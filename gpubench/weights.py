"""Weights from ``--seed``, made on the device in the layout the port's
``TorchModel`` takes (``models/model.py::init_params``'s tree), and handed
to both the program and the plain reference.

Every random matrix is a view into one flat buffer filled by a single
``torch.randn`` call in the served dtype from a generator on the device,
then scaled in place to its fan-in (the port's scales: ``fan_in ** -0.5``,
the embedding 1, a conv 0.2). The norms' scales are drawn too (0.1 ·
randn, applied as ``1 + scale``), so a fault in any norm shows in the
output; the SSM's f32 leaves (``A_log``, ``D``, ``dt_bias``) are the
port's constants, Mamba-2's ``A_log`` spread as Mamba-2's own
initialisation spreads it (``log`` of 1 .. 16 over the heads).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

# offsets in the flat buffer are multiples of this many elements, so every
# leaf starts 256-byte aligned (TMA loads want 16)
ALIGN = 128

# (path, shape, kind, scale): kind "randn" (scaled), "norm" (0.1 · randn),
# "zeros", "const" (scale is the value), "a_log1" (log 1 .. N over the
# state, f32), "a_log2" (log 1 .. 16 over the heads, f32), "ones32",
# "zeros32"
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]


def _attn(d: int, h: int, kv: int, hd: int, at) -> List[Leaf]:
    return [(at + ("wq",), (d, h, hd), "randn", d ** -0.5),
            (at + ("wk",), (d, kv, hd), "randn", d ** -0.5),
            (at + ("wv",), (d, kv, hd), "randn", d ** -0.5),
            (at + ("wo",), (h, hd, d), "randn", (h * hd) ** -0.5)]


def _mlp(d: int, f: int, gated: bool, at) -> List[Leaf]:
    out = [(at + ("wi",), (d, f), "randn", d ** -0.5),
           (at + ("wo",), (f, d), "randn", f ** -0.5)]
    if gated:
        out.append((at + ("wg",), (d, f), "randn", d ** -0.5))
    return out


def _mamba1(c: Dict, at) -> List[Leaf]:
    d = c["d_model"]
    e, n, w = c["ssm"]["expand"] * d, c["ssm"]["state_dim"], \
        c["ssm"]["conv_width"]
    r = max(1, d // 16)
    return [(at + ("in_proj",), (d, 2 * e), "randn", d ** -0.5),
            (at + ("conv_w",), (e, w), "randn", 0.2),
            (at + ("conv_b",), (e,), "zeros", 0.0),
            (at + ("x_proj",), (e, r + 2 * n), "randn", e ** -0.5),
            (at + ("dt_proj_w",), (r, e), "randn", r ** -0.5),
            (at + ("dt_proj_b",), (e,), "const", -4.0),
            (at + ("A_log",), (e, n), "a_log1", 0.0),
            (at + ("D",), (e,), "ones32", 0.0),
            (at + ("out_proj",), (e, d), "randn", e ** -0.5)]


def _mamba2(c: Dict, at) -> List[Leaf]:
    d = c["d_model"]
    e, n, w = c["ssm"]["expand"] * d, c["ssm"]["state_dim"], \
        c["ssm"]["conv_width"]
    nh = e // c["ssm"]["headdim"]
    return [(at + ("in_proj",), (d, 2 * e + 2 * n + nh), "randn", d ** -0.5),
            (at + ("conv_w",), (e + 2 * n, w), "randn", 0.2),
            (at + ("conv_b",), (e + 2 * n,), "zeros", 0.0),
            (at + ("dt_bias",), (nh,), "zeros32", 0.0),
            (at + ("A_log",), (nh,), "a_log2", 0.0),
            (at + ("D",), (nh,), "ones32", 0.0),
            (at + ("norm",), (e,), "norm", 0.0),
            (at + ("out_proj",), (e, d), "randn", e ** -0.5)]


def layout(c: Dict) -> List[Leaf]:
    """Every leaf of the model's weights, in the order they are drawn."""
    d, v = c["d_model"], c["vocab"]
    leaves: List[Leaf] = [(("embed",), (v, d), "randn", 1.0)]
    if c["family"] == "hybrid":
        k = c["hybrid_shared_every"]
        for g in range(c["n_layers"] // k):
            at = ("groups", g)
            for j in range(k - 1):
                leaves += _mamba2(c, at + ("mamba", j))
                leaves.append((at + ("norm_m", j), (d,), "norm", 0.0))
            leaves.append((at + ("norm_attn",), (d,), "norm", 0.0))
            leaves.append((at + ("norm_mlp",), (d,), "norm", 0.0))
        hd = c["head_dim"] or d // c["n_heads"]
        leaves += _attn(d, c["n_heads"], c["n_kv_heads"], hd,
                        ("shared", "attn"))
        leaves += _mlp(d, c["d_ff"], c["mlp_act"].endswith("gated"),
                       ("shared", "mlp"))
    elif c["family"] == "ssm":
        for i in range(c["n_layers"]):
            leaves.append((("layers", i, "norm"), (d,), "norm", 0.0))
            leaves += _mamba1(c, ("layers", i, "mamba"))
    else:
        raise ValueError(f"no weight layout for family {c['family']!r}")
    leaves.append((("final_norm",), (d,), "norm", 0.0))
    leaves.append((("lm_head",), (d, v), "randn", d ** -0.5))
    return leaves


def _put(tree, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if key not in node if isinstance(node, dict) else key >= len(node):
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, dict):
                node[key] = child
            else:
                node.append(child)
        node = node[key]
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class Weights:
    """The model's weights on ``device`` in ``dtype``: ``params`` is the
    port's tree, every leaf a view of ``flat`` or a small tensor of its
    own. ``fill(seed)`` draws them again in place, so a model built over
    them stays valid across seeds."""

    def __init__(self, c: Dict, dtype: torch.dtype, device) -> None:
        self.c = c
        self.dtype = dtype
        self.device = torch.device(device)
        self.leaves = layout(c)
        offsets, total = [], 0
        for _, shape, kind, _ in self.leaves:
            if kind in ("randn", "norm"):
                offsets.append(total)
                total += -(-_numel(shape) // ALIGN) * ALIGN
            else:
                offsets.append(None)
        self.flat = torch.empty(total, dtype=dtype, device=self.device)
        self.params: Dict[str, Any] = {}
        for (path, shape, kind, _), off in zip(self.leaves, offsets):
            if off is not None:
                t = self.flat[off:off + _numel(shape)].view(shape)
            elif kind in ("a_log1", "a_log2", "ones32", "zeros32"):
                t = torch.empty(shape, dtype=torch.float32,
                                device=self.device)
            else:
                t = torch.empty(shape, dtype=dtype, device=self.device)
            _put(self.params, path, t)
        self._views = [(self._leaf(path), kind, scale)
                       for path, _, kind, scale in self.leaves]

    def _leaf(self, path) -> torch.Tensor:
        node = self.params
        for key in path:
            node = node[key]
        return node

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t, _, _ in self._views)

    @torch.no_grad()
    def fill(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        torch.randn(self.flat.shape, generator=gen, dtype=self.dtype,
                    device=self.device, out=self.flat)
        for t, kind, scale in self._views:
            if kind == "randn":
                t.mul_(scale)
            elif kind == "norm":
                t.mul_(0.1)
            elif kind == "zeros" or kind == "zeros32":
                t.zero_()
            elif kind == "const":
                t.fill_(scale)
            elif kind == "ones32":
                t.fill_(1.0)
            elif kind == "a_log1":
                n = t.shape[-1]
                t.copy_(torch.log(torch.arange(
                    1, n + 1, dtype=torch.float32,
                    device=self.device)).expand(t.shape))
            elif kind == "a_log2":
                t.copy_(torch.log(torch.linspace(
                    1.0, 16.0, t.shape[0], dtype=torch.float32,
                    device=self.device)))
            else:
                raise ValueError(kind)
