"""The dry run of a few reduced cells on a (2, 2) ``("data", "model")``
mesh, in a process of its own, for ``tests/test_torch_dryrun.py``::

    python tests/_dryrun_cells.py ref OUT.json    # the JAX package's
    python tests/_dryrun_cells.py port OUT.json   # the port's

``ref`` runs the reference's ``repro.launch.dryrun.lower_cell`` on 4 host
devices with its ``make_production_mesh`` (Auto axes), ``get_arch``
(``reduced()``) and ``get_shape`` (``SHAPES``) swapped; then the same
``lower_cell`` on a mesh of ``jax.make_mesh``'s default (Explicit) axes,
which raises (ROADMAP C19); and the reference's ``collective_bytes`` on a
hand-written HLO line of each collective kind. ``port`` runs the port's
``lower_cell`` with the same swaps on a fake process group of 4 ranks
(``"cpu"`` mesh), the port's ``collective_bytes`` of one counted
collective of each kind, and the per-device counts of a batch-sharded
product against its global ones. Both write a JSON object to OUT.json.
"""
import json
import os
import sys

# reduced cells: (arch, shape name); shapes (seq, global batch, kind)
CELLS = [("gemma2-9b", "train"), ("mixtral-8x7b", "train"),
         ("zamba2-2.7b", "prefill"), ("gemma2-9b", "decode1")]
SHAPES = {"train": (64, 4, "train"), "prefill": (64, 4, "prefill"),
          "decode": (64, 4, "decode"), "decode1": (64, 1, "decode")}
# each collective of the accounting check: (kind, local operand shape,
# local result shape) of an f32 tensor on a group of 2 ranks
COLLECTIVES = [("all-reduce", (8, 128), (8, 128)),
               ("all-gather", (8, 128), (16, 128)),
               ("reduce-scatter", (8, 128), (4, 128)),
               ("all-to-all", (8, 128), (8, 128))]
KEYS = ("params_total", "params_active", "chips", "memory", "roofline")


def _hlo(kind, src, res):
    dims = lambda s: ",".join(map(str, s))  # noqa: E731
    return (f"  %c = f32[{dims(res)}]{{1,0}} {kind}(f32[{dims(src)}]{{1,0}} "
            f"%p), replica_groups={{{{0,1}},{{2,3}}}}, dimensions={{0}}")


def ref(out):
    import jax
    from jax.sharding import AxisType
    assert len(jax.devices()) == 4, jax.devices()
    from repro.configs import registry as R
    from repro.configs.base import ShapeConfig
    from repro.launch import dryrun as DR
    from repro.launch import roofline as RL
    DR.get_arch = lambda name: R.get_arch(name).reduced()
    DR.get_shape = lambda name: ShapeConfig(name, *SHAPES[name])
    DR.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    res = {"cells": {}}
    for arch, shape in CELLS:
        r = DR.lower_cell(arch, shape)
        res["cells"][f"{arch}:{shape}"] = {k: r[k] for k in KEYS}
    DR.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 2), ("data", "model"))
    try:
        DR.lower_cell("gemma2-9b", "decode1")
        res["c19"] = None
    except Exception as e:  # the fault this records
        res["c19"] = [type(e).__name__, str(e)]
    res["collectives"] = {kind: RL.collective_bytes(_hlo(kind, src, dst))
                          for kind, src, dst in COLLECTIVES}
    json.dump(res, open(out, "w"))


def port(out):
    import math
    import torch
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.probe import TensorSpec
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_mesh
    DR.fake_group(4)
    DR.get_arch = lambda name: R.get_arch(name).reduced()
    DR.get_shape = lambda name: ShapeConfig(name, *SHAPES[name])
    DR.make_production_mesh = lambda multi_pod=False, device=None: \
        make_mesh((2, 2), ("data", "model"), "cpu")
    res = {"cells": {}}
    for arch, shape in CELLS:
        r = DR.lower_cell(arch, shape, device="cpu")
        res["cells"][f"{arch}:{shape}"] = {
            **{k: r[k] for k in KEYS},
            "by_input": r["argument_bytes_by_input"],
            "expert_bytes_over_model": r["expert_bytes_over_model"]}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    ops = {"all-reduce": lambda t: funcol.all_reduce(t, "sum", (mesh, 0)),
           "all-gather": lambda t: funcol.all_gather_tensor(t, 0, (mesh, 0)),
           "reduce-scatter": lambda t: funcol.reduce_scatter_tensor(
               t, "sum", 0, (mesh, 0)),
           "all-to-all": lambda t: funcol.all_to_all_single(
               t, None, None, (mesh, 0))}
    res["collectives"], res["collective_shapes"] = {}, {}
    for kind, src, _ in COLLECTIVES:
        fake = FakeTensorMode()
        with fake:
            t = torch.empty(src)
        counts = DR.LocalCounts({t.untyped_storage()._cdata}, DR._axes(mesh))
        with fake, counts:
            funcol.wait_tensor(ops[kind](t))
        res["collectives"][kind] = RL.collective_bytes(counts.collectives)
        res["collective_shapes"][kind] = [
            [list(s), list(d)] for _, axis, s, d, _ in counts.collectives
            if axis == "data"]
    # a product batch-sharded over all four ranks: the rank's counts
    # against the global ones a mode around the DTensor op sees
    shapes = {"x": (4, 64, 64), "w": (4, 64, 224)}
    specs = {k: ((("data", "model")),) for k in shapes}

    def step(t):
        return torch.bmm(t["x"], t["w"])
    counts, local, _ = DR.count_local(
        step, {k: TensorSpec(s) for k, s in shapes.items()}, specs, mesh)
    whole = {k: torch.randn(s) for k, s in shapes.items()}
    flop = FlopCounterMode(display=False)
    with flop:
        placed = SH.distribute(whole, specs, mesh)
        torch.bmm(placed["x"], placed["w"])
    res["per_device"] = {
        "flops": counts.flops,
        "peak": sum(4 * math.prod(t.shape) for t in local) + counts.peak,
        "global_flops": flop.get_total_flops(),
        "global_bytes": 4 * (sum(4 * 64 * n for n in (64, 224))
                             + 4 * 64 * 224),
        "local_shapes": [list(t.shape) for t in local]}
    json.dump(res, open(out, "w"))


if __name__ == "__main__":
    {"ref": ref, "port": port}[sys.argv[1]](sys.argv[2])
    sys.stdout.flush()
    os._exit(0)
