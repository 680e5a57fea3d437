"""Production-mesh dry run: run every (arch x shape) cell's step on fake
shards over the production mesh and record its per-device memory, flops,
bytes, collectives and three-term roofline on the H100's constants.
Nothing is computed and no tensor is allocated on the card.

Port of ``src/repro/launch/dryrun.py``. The reference compiles each cell on
512 placeholder host devices and reads XLA's per-device program. The port
has no compiler to ask: it creates a fake process group (``torch.testing.
_internal.distributed.fake_pg``; 256 ranks, or 512 with ``--multi-pod``)
and builds the (16, 16) or (2, 16, 16) mesh over it
(``launch.mesh.make_production_mesh``), on ``"cuda"`` where a card is
present and on ``"cpu"`` where the caller asks (``--device cpu``). The
state is abstract (``abstract_train_state``, ``serve.decode.
abstract_cache``, ``launch.specs.input_specs``), placed by
``param_specs``/``batch_specs``/``cache_specs``: each argument is the
rank's shard as a fake tensor. ``lower_cell`` runs one train, prefill or
decode step on them, as the reference's branches at ``:56-104`` lower
theirs, under a dispatch mode that defers every op on DTensors
(``LocalCounts``): DTensor runs the op on the rank's shards, and the mode
counts those local ops and the collectives DTensor issues, with the
shapes the rank sees (a mode that took the DTensor ops themselves would
count global shapes; ``make_fx`` over the DTensor step records the
wrapper's global tensors on the card machine's torch 2.11). From that
run:

  * flops a device (``torch.utils.flop_counter``'s formulas: matrix
    products and the flash kernel's);
  * bytes accessed (each op's inputs and outputs, the eager program: the
    hand kernels one op each, nothing fused as XLA fuses);
  * collective bytes (``launch.roofline.collective_bytes``) by kind and by
    mesh axis;
  * per-device peak memory: the arguments plus the peak of the local
    tensors live over the run; an argument the step updates in place
    (the parameters and moments a train step donates, a decode cache)
    allocates nothing more, as the reference's donated aliases do not.

A cell's result keeps the reference's keys (``:112-129``), with
``fits_16GB`` replaced by ``fits_80GB``, a fit against the card's 80e9 B;
``lower_s`` is the counted runs' time and ``compile_s`` 0.
``collectives_by_axis`` and ``largest_collective`` break the collectives
down by mesh axis, ``expert_bytes_over_model`` is what moves expert
weights over ``model`` (0 under expert parallelism) and
``cache_bytes_in_collectives`` what moves a decode cache's sequence (0
under a context-parallel cache).

The fake group cannot share a process with a real one: the dry run runs
in a process of its own. Tests swap this module's ``make_production_mesh``,
``get_arch`` and ``get_shape``, as the reference's tests swap its.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--shape train_4k] [--jobs 8] [--out-dir build/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback

import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import ARCHS, cells, get_arch, get_shape
from repro_torch.core.probe import TensorSpec
from repro_torch.dist import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (
    data_axes, make_production_mesh, mesh_device_type,
)
from repro_torch.launch.specs import input_specs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.decode import (
    abstract_cache, make_prefill_step, make_serve_step,
)
from repro_torch.train.train_step import (
    abstract_train_state, make_train_step,
)


def fake_group(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives are traced, never run. An existing default group
    is kept (a test's smaller one)."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh_size(mesh, names) -> int:
    dims = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.size(dims.index(a)) for a in names)


def _axes(mesh) -> dict:
    """Process group name -> the mesh axes its ranks span ("data",
    "model", or several joined by "+" for a group DTensor flattened), for
    every group the process has."""
    from torch.distributed.distributed_c10d import _world
    coords = {int(r): c for c, r in
              zip(itertools.product(
                  *(range(n) for n in mesh.mesh.shape)),
                  mesh.mesh.flatten().tolist())}
    names = tuple(mesh.mesh_dim_names)
    out = {}
    for pg, name in _world.pg_names.items():
        ranks = [r for r in dist.get_process_group_ranks(pg) if r in coords]
        if not ranks:
            continue
        span = [n for i, n in enumerate(names)
                if len({coords[r][i] for r in ranks}) > 1]
        out[pg.group_name] = "+".join(span) or "none"
    return out


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def _local_spec(ts: TensorSpec, spec: tuple, mesh) -> TensorSpec:
    shape, _ = SH.local_shape_and_offset(ts.shape, mesh,
                                         SH.to_placements(spec, mesh))
    return TensorSpec(tuple(shape), ts.dtype, ts.device)


def _nbytes(ts: TensorSpec) -> int:
    return math.prod(ts.shape) * torch.empty((), dtype=ts.dtype).element_size()


class LocalCounts(TorchDispatchMode):
    """Counts of the rank's own program while a DTensor step runs on fake
    shards: an op on DTensors is passed on (``NotImplemented``), so DTensor
    dispatches it and this mode sees the ops DTensor runs on the rank's
    local tensors, each collective (``_c10d_functional``) among them, with
    the shapes the rank sees. Per op: the flops of
    ``torch.utils.flop_counter``'s formulas (the flash kernel registers
    one), the bytes of its tensor inputs and outputs (views and metadata
    queries move none), and every collective (``launch.roofline``'s kind,
    the mesh axis of its group, its shapes and bytes). Live bytes: each
    storage from its first tensor to the death of its last, the arguments'
    apart (``core.probe``'s convention). DTensor infers an op's output
    shapes by running it on tensors of the global shapes; those tensors,
    and everything made from them, are not the rank's and are not
    counted."""

    def __init__(self, arg_keys: set, axes: dict):
        super().__init__()
        self._args = arg_keys
        self._axes = axes
        self._refs = {}
        self.live = self.peak = 0
        self.flops = self.bytes_accessed = 0.0
        self.collectives = []

    def _known(self, t: torch.Tensor) -> bool:
        key = t.untyped_storage()._cdata
        return key in self._args or key in self._refs

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, st.nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [x for x in tree_flatten((args, kwargs))[0]
                if isinstance(x, torch.Tensor)]
        if any(SH.is_dtensor(x) for x in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if flat and not all(self._known(x) for x in flat):
            return out  # computed from DTensor's global-shape inference
        if not flat and _inferring_shapes():
            return out
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        if not getattr(func, "is_view", False) \
                and getattr(func, "namespace", None) != "prim":
            self.bytes_accessed += sum(map(_tensor_bytes, flat)) \
                + sum(map(_tensor_bytes, outs))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = RL.op_kind(func)
        if kind is not None:
            self.collectives.append(
                (kind, self._axes.get(RL.group_name(args), "?"),
                 tuple(args[0].shape), tuple(outs[0].shape) if outs else (),
                 _tensor_bytes(args[0]) + sum(map(_tensor_bytes, outs))))
        for x in outs:
            self._track(x)
        return out


@contextlib.contextmanager
def _strided_shards_sized_on_host():
    """DTensor sizes a strided shard (a view of a dim split over two mesh
    dims, e.g. [B, S] flattened with B on ``data`` and S on ``model``)
    with torch ops whose values it reads back on the host; on fake tensors
    those have no values. They run here outside the dispatch modes, on
    host ints."""
    from torch.distributed.tensor import placement_types as PT
    from torch.utils._python_dispatch import _disable_current_modes
    cls = getattr(PT, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def on_host(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)
    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _inferring_shapes() -> bool:
    """Called from DTensor's inference of an op's output shapes?"""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def count_local(step, args: dict, specs: dict, mesh, runs: int = 2):
    """``step(tree)`` over ``args`` (a dict tree of ``TensorSpec``s), each
    the rank's shard as a fake tensor placed by ``specs`` as a DTensor,
    under ``activation_mesh``: nothing is allocated and no collective
    runs. Counted on the last of ``runs`` runs: DTensor's first dispatch
    of an op at new placements does work of its own on the rank's tensors
    (falcon-mamba-7b's train step, reduced on a (16, 16) mesh, counted
    5.0x the bytes and 2.9x the live peak of its second run; the same
    flops and collectives). Returns (``LocalCounts``, the local
    ``TensorSpec``s of the arguments in order, the bytes of the rank's
    shards of what ``step`` returns)."""
    for _ in range(runs - 1):
        _count_once(step, args, specs, mesh)
    return _count_once(step, args, specs, mesh)


def _count_once(step, args: dict, specs: dict, mesh):
    leaves, tree = tree_flatten(args, is_leaf=_is_spec)
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, tuple))[0]
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} arguments, {len(spec_leaves)} specs")
    local = [_local_spec(t, s, mesh) for t, s in zip(leaves, spec_leaves)]
    fake = FakeTensorMode()
    with fake:
        shards = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in local]
    counts = LocalCounts({x.untyped_storage()._cdata for x in shards},
                         _axes(mesh))
    with fake:
        dts = [SH.placed(x, mesh, SH.to_placements(s, mesh), t.shape)
               for x, s, t in zip(shards, spec_leaves, leaves)]
    with torch.no_grad(), _strided_shards_sized_on_host(), fake, counts, \
            SH.activation_mesh(mesh):
        out = step(tree_unflatten(dts, tree))
        out_bytes = sum(_tensor_bytes(x.to_local() if SH.is_dtensor(x)
                                      else x)
                        for x in tree_flatten(out)[0]
                        if isinstance(x, torch.Tensor))
        del out
    return counts, local, out_bytes


def _expert_bytes_over_model(colls, cfg, mesh) -> int:
    """Bytes of the collectives over ``model`` whose tensors are expert
    weights (3-D, trailing dims an expert's [d, f] or [f, d], d whole or
    split over the data axes)."""
    if cfg.moe is None:
        return 0
    d, f = cfg.d_model, cfg.d_ff
    splits = {1, _mesh_size(mesh, ("data",)),
              _mesh_size(mesh, data_axes(mesh))}
    shapes = {(d // k, f) for k in splits} | {(f, d // k) for k in splits}
    return sum(nbytes for _, axis, src, res, nbytes in colls
               if axis == "model" and any(len(t) == 3 and t[1:] in shapes
                                          for t in (src, res)))


# What is traced. A prefill or a decode step is traced whole. A train step
# costs several times more to trace (its backward, its recompute, its
# microbatches), but every layer (a hybrid's every group) runs the same
# ops on the same shapes, and so does every microbatch
# (``train_step.compute_grads``), so a count grows by the same amount for
# each further one: a train step deeper than ``TRACED_DEPTHS[1]`` layers
# (groups) is traced at both depths, one of more than
# ``2 + TRACED_MICROBATCHES`` microbatches at 2 and 3 (of the same rows
# each), and every count is extrapolated along the line through the two
# (traced whole where a count does not grow). The live peak is affine in
# the depth too (the arguments are counted exactly, apart; the saved
# layer inputs grow by a layer's each; the rest is one layer's) and does
# not grow past the second microbatch.
# The first two layers are not yet typical: DTensor settles the residual's
# placements over them (falcon-mamba-7b's bytes grow by 106e6 from depth 2
# to 3 and by 167e6 a layer after, reduced on a (2, 2) mesh).
TRACED_DEPTHS = (3, 4)
TRACED_MICROBATCHES = 3


def traced_depths(cfg) -> tuple:
    """``TRACED_DEPTHS``, a whole pair apart from an even depth where layers
    alternate (gemma2's local and global layers differ in the attention's
    visible pairs)."""
    d1, d2 = TRACED_DEPTHS
    if cfg.local_global_alternate:
        d1 += d1 % 2
        return d1, d1 + 2
    return d1, d2


def _summary(body, args: dict, specs: dict, mesh, cfg, seq: int = 0) -> dict:
    """Run ``body`` over ``args`` and count the rank's program
    (``count_local``). A collective whose tensor has a dim of ``seq`` or
    of its share of a data axis (a KV cache's sequence, whole or
    context-parallel) is counted in ``cache``."""
    t0 = time.time()
    counts, _, out_bytes = count_local(body, args, specs, mesh)
    colls = counts.collectives
    by_axis = {axis: RL.collective_bytes([c for c in colls if c[1] == axis])
               for axis in {c[1] for c in colls}}
    largest = {axis: max(c[4] for c in colls if c[1] == axis)
               for axis in by_axis}
    seqs = {seq, seq // _mesh_size(mesh, ("data",)),
            seq // _mesh_size(mesh, data_axes(mesh))} - {0}
    cached = sum(nbytes for _, _, src, res, nbytes in colls
                 if seqs & (set(src) | set(res)))
    return {"flops": counts.flops, "bytes_accessed": counts.bytes_accessed,
            "cache": cached, "peak_live_bytes": counts.peak,
            "coll": RL.collective_bytes(colls), "by_axis": by_axis,
            "largest": largest,
            "expert": _expert_bytes_over_model(colls, cfg, mesh),
            "out_bytes": out_bytes, "traced": 1,
            "lower_s": time.time() - t0}


def _along(a: dict, b: dict, steps: float, peak_grows: bool) -> dict:
    """The counts ``steps`` further along the line from ``a`` to ``b``
    (``b`` one unit past ``a``)."""
    def grow(x, y):
        if isinstance(y, dict):
            return {k: grow(x.get(k, 0.0), y.get(k, 0.0))
                    for k in set(x) | set(y)}
        return y + steps * (y - x)
    out = {k: grow(a[k], b[k]) for k in
           ("flops", "bytes_accessed", "coll", "by_axis", "expert",
            "cache", "out_bytes")}
    out.update(peak_live_bytes=grow(a["peak_live_bytes"],
                                    b["peak_live_bytes"]) if peak_grows
               else max(a["peak_live_bytes"], b["peak_live_bytes"]),
               largest={k: max(a["largest"].get(k, 0), v)
                        for k, v in b["largest"].items()},
               traced=a["traced"] + b["traced"],
               lower_s=a["lower_s"] + b["lower_s"])
    return out


def _depth_cfg(cfg, units: int):
    """``cfg`` cut to ``units`` layers (a hybrid's: groups)."""
    per = cfg.hybrid_shared_every if cfg.family == "hybrid" else 1
    return dataclasses.replace(cfg, n_layers=units * per)


def _units(cfg) -> int:
    return cfg.n_layers // (cfg.hybrid_shared_every
                            if cfg.family == "hybrid" else 1)


def _step(cfg, shape, mesh, dev, attn_impl, opt_cfg, mb, param_dtype):
    """(args, specs, body, donated) of the cell's step for ``cfg``; a
    train step of ``mb`` microbatches over ``shape``'s rows."""
    params, opt = abstract_train_state(cfg, opt_cfg, param_dtype, device=dev)
    psp = SH.param_specs(cfg, params, mesh)
    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg, attn_impl=attn_impl,
                               num_microbatches=mb)
        batch = input_specs(cfg, shape, dev)

        def body(t):
            _, _, m = step(t["params"], {"mu": t["mu"], "nu": t["nu"],
                                         "step": 0}, t["batch"])
            return m["loss"]
        return ({"params": params, "mu": opt["mu"], "nu": opt["nu"],
                 "batch": batch},
                {"params": psp, "mu": psp, "nu": psp,
                 "batch": SH.batch_specs(cfg, batch, mesh)},
                body, ("params", "mu", "nu"))
    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, attn_impl=attn_impl)
        batch = input_specs(cfg, shape, dev)

        def body(t):
            # the output cache comes out placed by ``cache_specs``
            # (``models.model._cache_buffers``), as the reference pins it
            return prefill(t["params"], t["batch"])
        return ({"params": params, "batch": batch},
                {"params": psp, "batch": SH.batch_specs(cfg, batch, mesh)},
                body, ())
    serve = make_serve_step(cfg)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len,
                           device=dev)
    ctx_par = shape.global_batch < _mesh_size(mesh, ("data",))
    io = input_specs(cfg, shape, dev)

    def body(t):
        return serve(t["params"], t["cache"], t["tokens"], t["pos"])
    return ({"params": params, "cache": cache, "tokens": io["tokens"],
             "pos": io["pos"]},
            {"params": psp,
             "cache": SH.cache_specs(cfg, cache, mesh,
                                     context_parallel=ctx_par),
             "tokens": SH.batch_specs(cfg, {"tokens": io["tokens"]},
                                      mesh)["tokens"],
             "pos": ()},
            body, ("cache",))


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               attn_impl: str = "flash_kernel", opt_overrides: dict = None,
               device=None, param_dtype: torch.dtype = torch.bfloat16):
    """Trace and count one (arch x shape) cell (``TRACED_DEPTHS``), its
    parameters in ``param_dtype`` (the reference's ``abstract_train_state``
    default, bf16). Returns a result dict."""
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    dev = torch.device(mesh_device_type(device))
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = mesh.size()
    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype,
                              **(opt_overrides or {}))
        # each microbatch must still shard over the full data axis
        dax = _mesh_size(mesh, data_axes(mesh))
        mb = max(1, min(cfg.num_microbatches, shape.global_batch // dax))
    else:
        opt_cfg, mb = AdamWConfig(), 1

    def at_depth(c):
        def traced(shp, n):
            args, specs, body, _ = _step(c, shp, mesh, dev, attn_impl,
                                         opt_cfg, n, param_dtype)
            return _summary(body, args, specs, mesh, c,
                            shape.seq_len if shape.kind == "decode" else 0)
        if mb <= 2 + TRACED_MICROBATCHES:
            return traced(shape, mb)
        rows = shape.global_batch // mb
        two, three = (traced(dataclasses.replace(shape, global_batch=n * rows),
                             n)
                      for n in (TRACED_MICROBATCHES - 1, TRACED_MICROBATCHES))
        return _along(two, three, mb - TRACED_MICROBATCHES, False)

    units, (d1, d2) = _units(cfg), traced_depths(cfg)
    got = None
    if shape.kind == "train" and units > d2:
        a, b = at_depth(_depth_cfg(cfg, d1)), at_depth(_depth_cfg(cfg, d2))
        if all(b[k] >= a[k] for k in ("flops", "bytes_accessed",
                                      "peak_live_bytes")):
            got = _along(a, b, (units - d2) / (d2 - d1), True)
    if got is None:  # traced whole: inference, shallow, or not affine
        got = at_depth(cfg)
    # the arguments a device holds, by input: the whole depth's, exactly
    args, specs, _, donated = _step(cfg, shape, mesh, dev, attn_impl,
                                    opt_cfg, mb, param_dtype)
    spec_of = {k: tree_flatten(specs[k], is_leaf=lambda x:
                               isinstance(x, tuple))[0] for k in args}
    sizes = {k: sum(_nbytes(_local_spec(t, s, mesh)) for t, s in
                    zip(tree_flatten(args[k], is_leaf=_is_spec)[0],
                        spec_of[k])) for k in args}
    arg_bytes = sum(sizes.values())
    alias = sum(sizes[k] for k in donated)
    dtype = tree_flatten(args["params"], is_leaf=_is_spec)[0][0].dtype
    rl = RL.analyze({**got, "arg_bytes": arg_bytes}, got["coll"], cfg, shape,
                    chips, dtype)
    peak = rl.peak_mem_per_device
    result = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "chips": chips,
        "status": "ok",
        "lower_s": round(got["lower_s"], 2),
        "compile_s": 0.0,  # nothing compiles: counted as it runs
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": got["out_bytes"] + alias,
            "temp_bytes": got["peak_live_bytes"],
            "alias_bytes": alias,
            "peak_per_device": peak,
            "fits_80GB": peak <= RL.HBM_BYTES,
        },
        "argument_bytes_by_input": sizes,
        "roofline": rl.to_dict(),
        "collectives_by_axis": got["by_axis"],
        "largest_collective": got["largest"],
        "expert_bytes_over_model": got["expert"],
        "cache_bytes_in_collectives": got["cache"],
        "traces": got["traced"],
        "microbatches": mb,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "device": dev.type,
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    return result


def _cell_process(arch: str, shape: str, multi_pod: bool, device,
                  err_path: str):
    """One cell's dry run in a process of its own (``--jobs``), its
    standard error to ``err_path``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape] + (["--multi-pod"] if multi_pod else []) \
        + (["--device", str(device)] if device else [])
    with open(err_path, "w") as err:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True)


def run_all(multi_pod: bool, out_dir: str, only_arch=None, device=None,
            only_shape=None, jobs: int = 1):
    """Every cell (of ``only_arch``, of ``only_shape``), each result cached
    as JSON under ``out_dir``; with ``jobs`` > 1 that many cells at once,
    each in a process of its own."""
    os.makedirs(out_dir, exist_ok=True)
    summary, running = [], []
    for cfg, shape, skip in cells():
        if (only_arch and cfg.name != only_arch) \
                or (only_shape and shape.name != only_shape):
            continue
        tag = f"{cfg.name}__{shape.name}__{'2x16x16' if multi_pod else '16x16'}"
        path = os.path.join(out_dir, tag + ".json")
        if skip:
            res = {"arch": cfg.name, "shape": shape.name, "status": "SKIP",
                   "reason": "long_500k needs sub-quadratic attention "
                             "(DESIGN.md long_500k applicability)"}
        elif os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
            summary.append(res)
            print(f"[cached] {tag}")
            continue
        elif jobs > 1:
            while len(running) >= jobs:
                running = _reap(running, summary)
            print(f"[dryrun] {tag} started", flush=True)
            running.append((tag, path, cfg.name, shape.name, time.time(),
                            _cell_process(cfg.name, shape.name, multi_pod,
                                          device, path[:-5] + ".err")))
            continue
        else:
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                res = lower_cell(cfg.name, shape.name, multi_pod=multi_pod,
                                 device=device)
            except Exception as e:  # a failure here is a bug in our system
                res = {"arch": cfg.name, "shape": shape.name, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
        _report(tag, res)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        summary.append(res)
    while running:
        running = _reap(running, summary)
    n_ok = sum(1 for r in summary if r.get("status") == "ok")
    n_skip = sum(1 for r in summary if r.get("status") == "SKIP")
    n_fail = sum(1 for r in summary if r.get("status") == "FAIL")
    print(f"\n=== dry-run: {n_ok} ok / {n_skip} skip / {n_fail} FAIL ===")
    return summary


def _report(tag: str, res: dict) -> None:
    if res.get("status") == "ok":
        r = res["roofline"]
        print(f"  {tag} ok: compute={r['compute_s']:.3f}s "
              f"memory={r['memory_s']:.3f}s "
              f"collective={r['collective_s']:.3f}s "
              f"dominant={r['dominant']} "
              f"peak_mem={res['memory']['peak_per_device']/1e9:.2f}GB",
              flush=True)
    elif res.get("status") == "FAIL":
        print(f"  {tag} FAIL: {res['error']}", flush=True)


def _reap(running: list, summary: list) -> list:
    """Wait for one of the ``running`` cell processes to end; record its
    result (a process that fails is the cell's FAIL). Returns the rest."""
    while True:
        for i, (tag, path, arch, shape, t0, proc) in enumerate(running):
            if proc.poll() is None:
                continue
            out = proc.stdout.read()
            try:
                res = json.loads(out[out.index("{"):])
            except ValueError:
                with open(path[:-5] + ".err") as f:
                    lines = [ln for ln in f.read().splitlines()
                             if "Error" in ln or "Exception" in ln]
                res = {"arch": arch, "shape": shape, "status": "FAIL",
                       "error": f"exit {proc.returncode} after "
                                f"{time.time() - t0:.0f} s: "
                                + " | ".join(lines[-3:])[-600:]}
            _report(tag, res)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            summary.append(res)
            return running[:i] + running[i + 1:]
        time.sleep(1.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None,
                    help="one cell's shape (train_4k by default); with "
                         "--all, only the cells of this shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells at once, a process each")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--device", default=None,
                    help="cpu: a \"cpu\" fake mesh (default: the card)")
    args = ap.parse_args()
    if args.all or (args.arch is None):
        run_all(args.multi_pod, args.out_dir, only_arch=args.arch,
                device=args.device, only_shape=args.shape, jobs=args.jobs)
        return
    res = lower_cell(args.arch, args.shape or "train_4k",
                     multi_pod=args.multi_pod, device=args.device)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
