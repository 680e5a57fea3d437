"""Sharding rules: logical-axis activation constraints plus divisibility-aware
parameter / batch / cache specs, on ``DeviceMesh`` and ``DTensor``.

Port of ``src/repro/dist/sharding.py``. Two logical activation axes cover
every model in this repo:

  * ``batch`` — the mesh's data axes (``("pod", "data")`` when a pod axis
    is present, else ``("data",)``): batch / FSDP parallelism.
  * ``model`` — the ``model`` mesh axis: tensor / expert / sequence
    parallelism.

A spec is what the reference's ``PartitionSpec`` holds, as a plain tuple:
one entry per tensor dim, each None (replicated), a mesh axis name, or a
tuple of names (the dim split over several axes, in mesh order); ``()`` is
the reference's ``P()``. The rule tables and the divisibility-aware
``_axis_group`` / ``_entry`` / ``_spec_for`` are the reference's: a mesh
axis whose size does not divide the corresponding dim is dropped (that dim
stays replicated) instead of erroring, so one table covers a 2-kv-head
reduced config and a 128-head production config on the same 16 x 16 mesh.
The rules are written for the unstacked rank and aligned to the trailing
dims; the port keeps layers as lists of unstacked leaves, where the
reference stacks them on [L] (and the hybrid's groups on [G, k-1]), so a
port leaf's spec is the reference's without its leading stack entries.

``to_placements`` takes the place of ``to_named``: a spec becomes DTensor
placements, one per mesh dim (``Shard(d)`` for the tensor dim whose entry
names it, ``Replicate()`` otherwise). The spec functions take a
``DeviceMesh`` or an ``AbstractMesh`` (shape and names only), so the specs
of a 512-device mesh are computed without 512 ranks.

``constrain`` is the one entry point model code uses to pin activation
shardings: it redistributes a DTensor to the resolved placements. It is the
identity unless an ``activation_mesh`` context is active with more than one
device, and for a plain tensor, so the same model code runs unsharded.

Work a rank does on its own shards goes through a few helpers: ``placed``
wraps a shard as a DTensor (nothing sent), ``empty_placed`` allocates one
(a prefill's cache, placed by ``cache_specs``), ``write_into`` copies into
a DTensor's own shard (DTensor cannot redistribute an in-place op's
target), ``local_map`` runs a function shard by shard, ``row_block`` cuts a
microbatch from each rank's own rows, and ``local_shape_and_offset`` gives
a shard's shape and offset from the mesh coordinate in plain ints (what
the dry run's steps on fake tensors need).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map, tree_map_with_path

from repro_torch.configs.base import ArchConfig

_ACTIVE = threading.local()


class AbstractMesh:
    """A mesh's shape and axis names, without devices: what the spec
    functions read (``axis_names``, ``shape[name]``, ``size``)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())


def abstract(mesh) -> AbstractMesh:
    """``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``) as an
    ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(mesh.shape, mesh.mesh_dim_names)


def current_mesh():
    """The mesh installed by ``activation_mesh`` (None outside any context)."""
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def activation_mesh(mesh):
    """Install ``mesh`` as the target of ``constrain`` for the dynamic extent
    (of this thread).

    The launchers wrap the step in this context; model code stays
    mesh-agnostic and calls ``constrain`` unconditionally.
    """
    from repro_torch.dist import kernel_sharding
    kernel_sharding.register()
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def in_current_mesh(fn):
    """``fn`` run under the mesh active now: for a function called again
    later on another thread, as a checkpointed layer's recompute is, on
    the thread autograd runs a card's backward on."""
    mesh = current_mesh()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with activation_mesh(mesh):
            return fn(*args, **kwargs)
    return run


# ---------------------------------------------------------------------------
# logical -> mesh axis resolution (the reference's, on an AbstractMesh)
# ---------------------------------------------------------------------------

def _axis_group(mesh, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
    """Resolve a logical axis name to a tuple of mesh axes (None = replicate)."""
    if logical is None:
        return None
    names = mesh.axis_names
    if logical == "batch":
        group = tuple(a for a in ("pod", "data") if a in names)
        return group or None
    if logical in names:
        return (logical,)
    return None


def _group_size(mesh, group: Tuple[str, ...]) -> int:
    size = 1
    for a in group:
        size *= mesh.shape[a]
    return size


def _entry(mesh, dim: int, logical) -> Any:
    """One spec entry for a dim of size ``dim``, or None if the axis
    group's size does not divide it (replicate rather than error)."""
    group = _axis_group(mesh, logical)
    if group is None or dim % _group_size(mesh, group):
        return None
    return group[0] if len(group) == 1 else group


def _spec_for(mesh, shape: Sequence[int], logical_axes: Sequence) -> tuple:
    entries = [_entry(mesh, d, ax) for d, ax in zip(shape, logical_axes)]
    entries += [None] * (len(shape) - len(entries))
    return tuple(entries)


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    for the tensor dim ``d`` whose entry names that axis, else
    ``Replicate()``. A dim split over two axes (``("pod", "data")``) gets
    a ``Shard(d)`` on each, in mesh order, which is the reference's
    row-major split. A mesh dim of size 1 splits nothing and gets
    ``Replicate()``: DTensor refuses to reshape a sharded dim even where
    the shard is the whole (a batch of one), and on the card its view of a
    trivially sharded gradient can disagree with the local tensor's
    strides."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            where[name] = d
    m = abstract(mesh)
    return [Shard(where[a]) if a in where and m.shape[a] > 1 else Replicate()
            for a in m.axis_names]


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Redistribute a DTensor ``x`` to the placements of ``logical_axes``
    under the active activation mesh.

    ``logical_axes`` has one entry per dim of ``x``: "batch", "model", any
    literal mesh axis name, or None. Outside an ``activation_mesh`` context,
    on a trivial 1-device mesh, or for a plain tensor it keeps the
    placements, so model code can pin shardings unconditionally: a plain
    tensor comes back as it is, a DTensor under a mesh contiguous.
    """
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if abstract(mesh).size > 1:
        placements = to_placements(_spec_for(abstract(mesh), x.shape,
                                             logical_axes), mesh)
        if list(x.placements) != placements:
            x = x.redistribute(x.device_mesh, placements)
    # contiguous, on any mesh: DTensor runs a reshape of its local tensor
    # as a view, which a permuted product's layout (the projections'
    # einsums) cannot take in the backward
    return x.contiguous()


def grad_to(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` as it is, its gradient brought to the placements of
    ``logical_axes`` under the active mesh (``_PinGrad``): where a block's
    output joins a sequence-sharded residual, the gradient it hands back
    arrives split on the sequence, and a product's backward would flatten
    [B, S] split on two mesh dims, which DTensor refuses (torch 2.11)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or abstract(mesh).size == 1 \
            or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _PinGrad.apply(x, to_placements(
        _spec_for(abstract(mesh), x.shape, logical_axes), mesh))


class _PinGrad(torch.autograd.Function):
    """The identity, whose gradient is brought to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and list(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# Rules are written for the UNSTACKED param rank and aligned to the trailing
# dims; leading layer/group stack dims stay replicated. "data" = FSDP axis,
# "model" = tensor/expert-parallel axis.
_PARAM_RULES = {
    # top level
    ("", "embed"): ("model", "data"),          # [V, d]: vocab-parallel
    ("", "lm_head"): ("data", "model"),        # [d, V]
    # attention (Megatron TP: heads on model, d_model FSDP on data)
    ("attn", "wq"): ("data", "model", None),   # [d, H, hd]
    ("attn", "wk"): ("data", "model", None),   # [d, Hkv, hd]
    ("attn", "wv"): ("data", "model", None),
    ("attn", "wo"): ("model", None, "data"),   # [H, hd, d]
    ("attn", "bq"): ("model", None),
    ("attn", "bk"): ("model", None),
    ("attn", "bv"): ("model", None),
    # dense MLP (column- then row-parallel)
    ("mlp", "wi"): ("data", "model"),          # [d, f]
    ("mlp", "wg"): ("data", "model"),
    ("mlp", "wo"): ("model", "data"),          # [f, d]
    # MoE (expert-parallel on model when E divides it; FSDP on d)
    ("moe", "router"): ("data", None),         # [d, E]
    ("moe", "wi"): ("model", "data", None),    # [E, d, f]
    ("moe", "wg"): ("model", "data", None),
    ("moe", "wo"): ("model", None, "data"),    # [E, f, d]
    # Mamba blocks: the expanded channel dim e plays the TP role
    ("mamba", "in_proj"): ("data", "model"),   # [d, 2e(+...)]
    ("mamba", "conv_w"): ("model", None),      # [e(+2n), W]
    ("mamba", "conv_b"): ("model",),
    ("mamba", "x_proj"): ("model", None),      # [e, r+2n]
    ("mamba", "dt_proj_w"): (None, "model"),   # [r, e]
    ("mamba", "dt_proj_b"): ("model",),
    ("mamba", "out_proj"): ("model", "data"),  # [e, d]
    # A_log / D / dt_bias / norm: small state tensors, replicated
}

_PARENTS = frozenset(p for p, _ in _PARAM_RULES if p)


def _path_names(path) -> Tuple[str, ...]:
    names = []
    for k in path:
        names.append(getattr(k, "key", getattr(k, "name", str(k))))
    return tuple(names)


def _param_rule(path) -> Optional[Tuple]:
    names = _path_names(path)
    name = names[-1]
    parent = next((n for n in reversed(names[:-1]) if n in _PARENTS), "")
    return _PARAM_RULES.get((parent, name)) or _PARAM_RULES.get(("", name))


def param_specs(cfg: ArchConfig, params, mesh):
    """Spec tree (FSDP + TP) for a param tree of tensors, meta tensors or
    ``TensorSpec``s. Optimizer moments reuse these specs unchanged."""
    mesh = abstract(mesh)

    def leaf_spec(path, leaf):
        rule = _param_rule(path)
        ndim = len(leaf.shape)
        if rule is None or ndim < len(rule):
            return ()
        lead = ndim - len(rule)
        logical = (None,) * lead + tuple(rule)
        return _spec_for(mesh, leaf.shape, logical)

    return tree_map_with_path(leaf_spec, params)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, batch, mesh):
    """Shard every input's leading (batch) dim over the data axes; scalars
    (e.g. decode ``pos``) stay replicated."""
    mesh = abstract(mesh)

    def leaf_spec(leaf):
        if len(leaf.shape) == 0:
            return ()
        logical = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return _spec_for(mesh, leaf.shape, logical)

    return tree_map(leaf_spec, batch)


# Cache layouts (repro_torch.models.decode.init_cache), keyed by leaf name:
#   k/v     [L|G, B, Hkv, S, hd]     k_s/v_s [L, B, Hkv, S]
#   conv    [L, B, W-1, e]           ssm     [L, B, e, N]
#   m_conv  [G, k-1, B, W-1, e+2n]   m_ssm   [G, k-1, B, nh, hd, N]
# ``context_parallel`` moves the data axes onto the sequence dim for
# small-batch long-context decode (global_batch < data-axis size).
_CACHE_RULES = {
    "k": (None, "batch", "model", None, None),
    "v": (None, "batch", "model", None, None),
    "k_s": (None, "batch", "model", None),
    "v_s": (None, "batch", "model", None),
    "conv": (None, "batch", None, "model"),
    "ssm": (None, "batch", "model", None),
    "m_conv": (None, None, "batch", None, "model"),
    "m_ssm": (None, None, "batch", "model", None, None),
}
_CACHE_SEQ_DIM = {"k": 3, "v": 3, "k_s": 3, "v_s": 3}


def cache_specs(cfg: ArchConfig, cache, mesh, *, context_parallel: bool = False):
    """Specs for a decode/prefill cache tree."""
    mesh = abstract(mesh)

    def leaf_spec(path, leaf):
        name = _path_names(path)[-1]
        rule = _CACHE_RULES.get(name)
        if rule is None or len(leaf.shape) != len(rule):
            return ()
        logical = list(rule)
        if context_parallel and name in _CACHE_SEQ_DIM:
            # batch too small to shard: put the data axes on the sequence dim
            logical[1] = None
            logical[_CACHE_SEQ_DIM[name]] = "batch"
        return _spec_for(mesh, leaf.shape, logical)

    return tree_map_with_path(leaf_spec, cache)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the placements
    of its spec: every rank passes the same whole tensor and keeps its own
    shard of it (a local slice, nothing sent; on a mesh of one device the
    tensor itself). Non-tensor leaves pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist import kernel_sharding
    kernel_sharding.register()
    whole = [Replicate()] * mesh.ndim

    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(x, mesh, whole, run_check=False) \
            .redistribute(mesh, to_placements(spec, mesh))
    return zip_map(place, tree, specs)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` with ``specs`` a tree of the same
    structure whose leaves are spec tuples."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed whole onto every rank (``Replicate`` on
    every mesh dim); a plain tensor as is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    want = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``t`` the model made (positions, rotary angles) as a
    replicated DTensor on ``x``'s mesh when ``x`` is a DTensor, so the ops
    that mix them, and their backward on autograd's own threads, see
    DTensors only; else ``t`` as is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def placed(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` whose shard on this rank is ``local``
    (nothing sent)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def local_shape_and_offset(shape, mesh, placements):
    """This rank's shard of a tensor of global ``shape`` under
    ``placements``: (its shape, the global index of its first element).
    A dim split over several mesh dims is split in mesh order, as DTensor
    splits it (``torch.chunk``'s sizes). Plain ints from the mesh's
    coordinate: no tensor is made or read for it, which a step run on
    fake tensors (the dry run) could not read."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    shape, off = list(shape), [0] * len(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim, mesh.size(i)
            size = -(-shape[d] // n)
            start = min(coord[i] * size, shape[d])
            off[d] += start
            shape[d] = min(size, shape[d] - start)
    return tuple(shape), tuple(off)


def empty_placed(shape, dtype: torch.dtype, spec: tuple, mesh
                 ) -> torch.Tensor:
    """An uninitialised DTensor of global ``shape`` placed by ``spec``:
    only this rank's shard is allocated."""
    placements = to_placements(spec, mesh)
    local, _ = local_shape_and_offset(shape, mesh, placements)
    return placed(torch.empty(local, dtype=dtype, device=mesh.device_type),
                  mesh, placements, shape)


def local_map(fn, t: torch.Tensor, shapes):
    """``fn`` on a DTensor's own shard, each tensor it returns (one, or a
    tuple for a tuple of ``shapes``) placed as ``t`` is, with the global
    shape given; ``fn(t)`` for a plain tensor. For work that a shard does
    alone (a ring's roll along a dim that is whole, a quantization along
    the last dim): nothing is sent."""
    if not is_dtensor(t):
        return fn(t)
    out = fn(t.to_local())
    if not isinstance(out, tuple):
        return placed(out, t.device_mesh, t.placements, shapes)
    return tuple(placed(o, t.device_mesh, t.placements, s)
                 for o, s in zip(out, shapes))


def row_block(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """The i-th of n blocks of ``t``'s rows (a microbatch). Of a DTensor
    whose rows are split over ranks, the i-th block of each rank's own
    rows: the blocks of all ranks make the i-th microbatch, which keeps the
    batch's placements, and nothing is sent (slicing the global rows would
    gather them). A different choice of rows than the unsharded split's;
    the microbatches' gradients sum to the same."""
    from torch.distributed.tensor import Shard
    b = t.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    if not (is_dtensor(t) and any(isinstance(p, Shard) and p.dim == 0
                                  for p in t.placements)):
        return t[i * (b // n):(i + 1) * (b // n)]
    loc = t.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"a rank's {loc.shape[0]} rows do not split into "
                         f"{n} microbatches")
    m = loc.shape[0] // n
    return placed(loc[i * m:(i + 1) * m], t.device_mesh, t.placements,
                  (b // n,) + tuple(t.shape[1:]))


def write_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``; into a DTensor ``dst`` (a cache, or a view of
    one) through its own shard, ``src`` first brought to ``dst``'s
    placements (a plain ``src`` is taken as replicated). DTensor cannot
    redistribute the target of an in-place op, so a cache keeps the
    placements it was made with."""
    if not is_dtensor(dst):
        return dst.copy_(src)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(mesh, dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst


def on_rows(fn, params, *tensors):
    """``fn(params, *tensors)`` on each rank's rows: the DTensors of
    ``tensors`` brought to their rows as the first one places its dim 0
    (split where it is, whole elsewhere) and passed as this rank's plain
    tensors, every DTensor of ``params`` made whole (its gradient a
    partial sum over the axes that split the rows); each tensor ``fn``
    returns (leading dim the rows) placed back as those rows. For a block
    whose ops DTensor cannot shard on its torch (the Mamba blocks: a
    reshape of split channels, torch 2.11): the block's work is split by
    rows only."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    first = next(t for t in tensors if is_dtensor(t))
    mesh = first.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in first.placements]
    grads = [Partial() if isinstance(pl, Shard) else Replicate()
             for pl in rows]

    def local(t):
        if not is_dtensor(t):
            return t
        if list(t.placements) != rows:
            t = t.redistribute(mesh, rows)
        return t.to_local()

    out = fn(tree_map(lambda t: replicated(t).to_local(grad_placements=grads)
                      if is_dtensor(t) else t, params),
             *map(local, tensors))
    return tree_map(lambda y: placed(y, mesh, rows, (first.shape[0],)
                                     + tuple(y.shape[1:]))
                    if isinstance(y, torch.Tensor) else y, out)
