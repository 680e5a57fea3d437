"""One rank of a multi-rank check of the port's distribution on the CPU.

``tests/test_torch_dist*.py`` start ``world`` processes of this script,
one per rank, over a gloo process group on a ``FileStore``::

    python tests/_dist_ranks.py CASE RANK WORLD STORE WORKDIR

Each case reads its inputs from ``WORKDIR`` and rank 0 writes what the test
compares (``WORKDIR/CASE.pkl``); a failed check raises, and the process
exits non-zero. No JAX here: the reference's numbers come from the test.
"""
import dataclasses
import os
import pickle
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.pipeline import (  # noqa: E402
    make_pipeline_forward, stack_stage_params,
)
from repro_torch.launch.mesh import init_file_group, make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.elastic import (  # noqa: E402
    rescale_batch_size, reshard_state,
)
from repro_torch.train.train_step import make_train_step  # noqa: E402

LR = 1e-3
STEPS = 2


def opt_cfg():
    return adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def names(placements):
    """Placements as (kind, dim) pairs."""
    return tuple((type(p).__name__, getattr(p, "dim", None))
                 for p in placements)


def whole(tree):
    """Every DTensor of ``tree`` as a plain tensor on the host."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def sharded_steps(cfg, mesh, params, opt, batches, **kw):
    """``STEPS`` of the port's train step on ``mesh``: params and moments
    placed by ``param_specs``, each batch by ``batch_specs``."""
    specs = SH.param_specs(cfg, params, mesh)
    params = SH.distribute(params, specs, mesh)
    opt = {"mu": SH.distribute(opt["mu"], specs, mesh),
           "nu": SH.distribute(opt["nu"], specs, mesh), "step": opt["step"]}
    step = make_train_step(cfg, opt_cfg(), **kw)
    metrics = []
    with SH.activation_mesh(mesh):
        for b in batches:
            b = SH.distribute(b, SH.batch_specs(cfg, b, mesh), mesh)
            params, opt, m = step(params, opt, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, params, opt


def case_step(rank, mesh, workdir):
    """The sharded step on (2, 2) from parameters converted from JAX, for
    each case of ``start.pkl``: an arch's reduced config, and with
    ``+seq`` the residual's sequence sharded on ``model``."""
    with open(os.path.join(workdir, "start.pkl"), "rb") as f:
        start = pickle.load(f)
    out = {}
    for case, (params, state, batches) in start.items():
        arch, _, seq = case.partition("+")
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  seq_shard_activations=seq == "seq")
        p = convert.params_from_jax(params, cfg, "cpu")
        o = convert.opt_state_from_jax(state, cfg, "cpu")
        bs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
        seen, experts = set(), set()
        with recording_constrain(seen), recording_experts(experts):
            metrics, p, o = sharded_steps(cfg, mesh, p, o, bs)
        placements = sorted({names(x.placements) for x in tree_leaves(p)
                             if isinstance(x, DTensor)})
        out[case] = (metrics, whole(p), whole({"mu": o["mu"],
                                                "nu": o["nu"]}), o["step"],
                     placements, sorted(seen))
        if cfg.moe is not None:
            out[case + ":experts"] = (sorted(experts),
                                      traced_expert_bytes(cfg, mesh))
    return out


class recording_experts:
    """The shapes of the expert weights the FFN takes (``wi``) while the
    block runs, added to ``seen``."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        self.orig = MOE.expert_ffn

        def rec(p, rows, group_sizes, act):
            self.seen.add(tuple(p["wi"].shape))
            return self.orig(p, rows, group_sizes, act)
        MOE.expert_ffn = rec

    def __exit__(self, *exc):
        MOE.expert_ffn = self.orig


def traced_expert_bytes(cfg, mesh) -> int:
    """The sharded train step of ``cfg`` on ``mesh`` run on fake shards
    (``launch.dryrun.count_local``: nothing allocated, no collective
    runs): the bytes of expert weights in its collectives over
    ``model``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.specs import input_specs
    from repro_torch.train.train_step import abstract_train_state
    params, opt = abstract_train_state(cfg, opt_cfg(), torch.float32)
    batch = input_specs(cfg, ShapeConfig("t", 64, 8, "train"))
    psp = SH.param_specs(cfg, params, mesh)
    step = make_train_step(cfg, opt_cfg())

    def body(t):
        return step(t["params"], {"mu": t["mu"], "nu": t["nu"], "step": 0},
                    t["batch"])[2]["loss"]
    counts, _, _ = DR.count_local(
        body, {"params": params, "mu": opt["mu"], "nu": opt["nu"],
               "batch": batch},
        {"params": psp, "mu": psp, "nu": psp,
         "batch": SH.batch_specs(cfg, batch, mesh)}, mesh)
    return DR._expert_bytes_over_model(counts.collectives, cfg, mesh)


def case_serve(rank, mesh, workdir):
    """For each case of ``serve.pkl``: the sharded prefill (parameters
    converted from JAX, placed by ``param_specs``; the batch by
    ``batch_specs``), its cache's placements, then the cache padded for
    decode (``serve.decode.decode_cache`` of the whole cache), placed by
    ``cache_specs`` (context-parallel where asked) and the decode steps on
    the reference's greedy tokens. Returns the logits, whole."""
    with open(os.path.join(workdir, "serve.pkl"), "rb") as f:
        start = pickle.load(f)
    out = {}
    for case, (arch, kv, cp, params, tok, feed, max_seq) in start.items():
        cfg = get_arch(arch).reduced()
        if kv:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        p = convert.params_from_jax(params, cfg, "cpu")
        p = SH.distribute(p, SH.param_specs(cfg, p, mesh), mesh)
        batch = {"tokens": torch.from_numpy(tok)}
        batch = SH.distribute(batch, SH.batch_specs(cfg, batch, mesh), mesh)
        with SH.activation_mesh(mesh):
            logits, cache = TS.make_prefill_step(cfg)(p, batch)
        pinned = {k: (names(v.placements), names(SH.to_placements(
            SH.cache_specs(cfg, {k: v}, mesh)[k], mesh)))
            for k, v in cache.items()}
        cache = TS.decode_cache(cfg, whole(cache), max_seq)
        cache = SH.distribute(cache, SH.cache_specs(
            cfg, cache, mesh, context_parallel=cp), mesh)
        placed = {k: names(v.placements) for k, v in cache.items()}
        steps = []
        for i, nxt in enumerate(feed):
            t = {"tokens": torch.from_numpy(nxt)}
            t = SH.distribute(t, SH.batch_specs(cfg, t, mesh), mesh)
            with SH.activation_mesh(mesh):
                lg, cache = TS.make_serve_step(cfg)(
                    p, cache, t["tokens"],
                    torch.tensor(tok.shape[1] + i, dtype=torch.int32))
            steps.append(lg.full_tensor())
        out[case] = (logits.full_tensor(), steps, pinned, placed)
    return out


class recording_constrain:
    """The model's ``constrain`` while the block runs, adding the
    placements of every residual [B, S, d] it returns to ``seen``."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        self.orig = M.constrain

        def rec(x, *logical):
            y = self.orig(x, *logical)
            if isinstance(y, DTensor) and len(logical) == 3 \
                    and logical[0] == "batch":
                self.seen.add(names(y.placements))
            return y
        M.constrain = rec

    def __exit__(self, *exc):
        M.constrain = self.orig


def pipeline_grads(pipe, w, x, loss, dtensor_mesh=None):
    """y, the stage params' gradient and x's through ``pipe`` on this
    rank, for ``loss(y)``: ``w`` a tree of stacked stage params (placed
    as DTensors sharded on the stage dim of ``dtensor_mesh`` when given;
    their gradient is then this rank's local shard)."""
    if dtensor_mesh is not None:
        w = tree_map(lambda t: SH.distribute(
            t, ("stage",) + (None,) * (t.dim() - 1), dtensor_mesh), w)
    w = tree_map(lambda t: t.detach().requires_grad_(), w)
    x = x.clone().requires_grad_()
    y = pipe(w, x)
    loss(y).backward()
    gw = tree_map(lambda t: t.grad.to_local() if isinstance(t.grad, DTensor)
                  else t.grad, w)
    return y.detach(), gw, x.grad


def case_pipe(rank, workdir):
    """The pipeline's forward and backward on the inputs of ``pipe.pkl``:
    4 stages of tanh layers (8 layers, d 32) at 4 and 8 microbatches with
    plain and DTensor stage params, and reduced gemma2-9b's 4 attention
    layers on 2 stages (a (2, 2) ("stage", "rep") mesh: two pipelines of
    2 stages). Every rank's y, stage params' gradient and x's gradient, by
    rank."""
    with open(os.path.join(workdir, "pipe.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    stages = make_mesh((4,), ("stage",), "cpu")
    w, x = torch.from_numpy(inp["w"]), torch.from_numpy(inp["x"])

    def tanh_layers(sp, h):
        for wl in sp:
            h = torch.tanh(h @ wl)
        return h
    for n_micro in (4, 8):
        pipe = make_pipeline_forward(tanh_layers, stages, n_micro=n_micro)
        sw = stack_stage_params(w, 4)
        out[f"tanh{n_micro}"] = pipeline_grads(
            pipe, sw, x, lambda y: (y ** 2).sum())
        out[f"tanh{n_micro}_dtensor"] = pipeline_grads(
            pipe, sw, x, lambda y: (y ** 2).sum(), dtensor_mesh=stages)

    cfg = dataclasses.replace(get_arch("gemma2-9b").reduced(), n_layers=4)
    params = convert.params_from_jax(inp["gemma_params"], cfg, "cpu")
    layers = tree_map(lambda *ls: torch.stack(ls), *params["layers"])
    h = torch.from_numpy(inp["gemma_x"])
    positions = torch.arange(h.shape[1])

    def attn_layers(sp, h):
        for j in range(len(sp["norm1"])):
            h, _ = M._attn_layer(tree_map(lambda t: t[j], sp), h, cfg, j,
                                 positions, "flash_kernel", None)
        return h
    two = make_mesh((2, 2), ("stage", "rep"), "cpu")
    pipe = make_pipeline_forward(attn_layers, two, n_micro=2, axis="stage")
    out["gemma"] = pipeline_grads(pipe, stack_stage_params(layers, 2), h,
                                  lambda y: (y ** 2).mean())
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, out))
    return by_rank


def case_misc(rank, mesh, workdir):
    out = {"pipe": case_pipe(rank, workdir)}
    # -- the pipeline: 4 stages, 8 layers, against the sequential stack
    stages = make_mesh((4,), ("stage",), "cpu")
    gen = torch.Generator().manual_seed(0)
    L, d = 8, 32
    w = torch.randn(L, d, d, generator=gen) * 0.1
    x = torch.randn(8, 16, d, generator=gen)

    def layer_fn(sp, h):
        for wl in sp:
            h = torch.tanh(h @ wl)
        return h
    ref = layer_fn(w, x)
    for n_micro in (4, 8):
        pipe = make_pipeline_forward(layer_fn, stages, n_micro=n_micro)
        y = pipe(stack_stage_params(w, 4), x)
        out[f"pipeline{n_micro}"] = float((y - ref).abs().max())
    # stage params as DTensors sharded on the stage dim
    sw = SH.distribute(stack_stage_params(w, 4), (("stage",) + (None,) * 3),
                       stages)
    y = make_pipeline_forward(layer_fn, stages, n_micro=4)(sw, x)
    out["pipeline_dtensor"] = float((y - ref).abs().max())

    # -- elastic reshard (2, 2) -> (2, 1), params and moments bit-equal
    cfg = get_arch("llama3-405b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    opt = adamw.init_state(opt_cfg(), params)
    g2 = torch.Generator().manual_seed(1)
    opt = {"mu": tree_map(lambda t: torch.randn(t.shape, generator=g2),
                          opt["mu"]),
           "nu": tree_map(lambda t: torch.rand(t.shape, generator=g2),
                          opt["nu"]), "step": 3}
    specs = SH.param_specs(cfg, params, mesh)
    p1 = SH.distribute(params, specs, mesh)
    o1 = {"mu": SH.distribute(opt["mu"], specs, mesh),
          "nu": SH.distribute(opt["nu"], specs, mesh), "step": 3}
    small = make_mesh((2, 1), ("data", "model"), "cpu", ranks=[0, 1])
    p2, o2 = reshard_state(cfg, p1, o1, small)
    if rank >= 2:
        assert (p2, o2) == (None, None)
    else:
        for a, b in zip(tree_leaves((params, opt["mu"], opt["nu"])),
                        tree_leaves((p2, o2["mu"], o2["nu"]))):
            assert b.device_mesh is small
            assert torch.equal(a, b.full_tensor())
        assert o2["step"] == 3
        out["elastic_placements"] = sorted(
            {names(b.placements) for b in tree_leaves(p2)})
    assert rescale_batch_size(256, 16, 8) == 128

    # -- compression of DTensors: the global blocks, bit for bit
    gen = torch.Generator().manual_seed(2)
    comp = []
    for shape, placements in [((64, 8), [Shard(0), Replicate()]),
                              ((64, 8), [Shard(0), Shard(0)]),
                              ((30, 7), [Shard(0), Replicate()]),
                              ((64, 8), [Replicate(), Shard(1)]),
                              ((5, 300), [Replicate(), Replicate()])]:
        g = torch.randn(shape, generator=gen) * 3
        dg = DTensor.from_local(g, mesh, [Replicate()] * 2) \
            .redistribute(mesh, placements)
        q = C.compress_decompress(dg)
        assert tuple(q.placements) == tuple(placements)
        assert torch.equal(q.full_tensor(), C.compress_decompress(g))
        comp.append(C.blocks_are_local(dg))
    out["blocks_are_local"] = comp

    # -- constrain: the identity off a mesh, placements on one
    t = DTensor.from_local(torch.ones(4, 6), mesh, [Replicate()] * 2)
    assert SH.constrain(t, "batch", "model") is t
    with SH.activation_mesh(mesh):
        c = SH.constrain(t, "batch", "model")
        plain = torch.ones(4, 6)
        assert SH.constrain(plain, "batch", None) is plain
    out["constrain"] = names(c.placements)
    assert torch.equal(c.full_tensor(), torch.ones(4, 6))

    # -- 4 compressed steps with error feedback on one batch
    cfg = get_arch("qwen1.5-32b").reduced()
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab, (4, 64), generator=gen)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    err = {}

    def compressor(grads):
        if "e" not in err:
            err["e"] = C.init_error_state(grads)
        q, err["e"] = C.apply_with_error_feedback(grads, err["e"])
        return q
    losses = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        err.clear()
        p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                        torch.device("cpu"))
        o = adamw.init_state(opt_cfg(), p)
        if m is None:
            step = make_train_step(cfg, opt_cfg(), grad_compressor=compressor)
            ls = []
            for _ in range(4):
                p, o, met = step(p, o, batch)
                ls.append(float(met["loss"]))
        else:
            ls = [lo for lo, _ in sharded_steps(
                cfg, m, p, o, [batch] * 4, grad_compressor=compressor)[0]]
        losses[name] = ls
    out["compressed_losses"] = losses

    # -- the launcher on the (2, 2) mesh through the sharded scheduler
    from repro_torch.core.scheduler import ShardedScheduler
    from repro_torch.launch.train import train
    res = train("gemma2-9b", steps=2, batch=4, seq=64, device="cpu",
                mesh_shape=(2, 2), log_every=100,
                scheduler=ShardedScheduler(pods=1, rows=2, cols=2))
    plain = train("gemma2-9b", steps=2, batch=4, seq=64, device="cpu",
                  log_every=100)
    out["launcher"] = {"losses": res["losses"], "plain": plain["losses"],
                       "gnorms": res["grad_norms"],
                       "plain_gnorms": plain["grad_norms"],
                       "chips": res["probe"].chips,
                       "hbm": (res["probe"].hbm_bytes,
                               plain["probe"].hbm_bytes),
                       "status": res["status"],
                       "stragglers": res["stragglers"]}
    return out


def case_one(rank, mesh, workdir):
    """World size 1 on a (1, 1) mesh, as on one card: the launcher against
    the unsharded launcher, and compressed steps."""
    from repro_torch.core.scheduler import ShardedScheduler
    from repro_torch.launch.train import train
    kw = dict(steps=3, batch=2, seq=64, device="cpu", log_every=100)
    res = train("gemma2-9b", mesh_shape=(1, 1),
                scheduler=ShardedScheduler(pods=1, rows=1, cols=1), **kw)
    plain = train("gemma2-9b", **kw)
    return {"losses": res["losses"], "plain": plain["losses"],
            "gnorms": res["grad_norms"], "plain_gnorms": plain["grad_norms"],
            "status": res["status"], "chips": res["probe"].chips}


CKPT_ARCH, CKPT_BATCH, CKPT_SEQ = "qwen1.5-32b", 4, 32
CKPT_STEPS, CKPT_AT = 6, 4


def case_ckpt(rank, mesh, workdir):
    """Checkpoints of a sharded run through ``launch.train.train``: 6 steps
    uninterrupted on (2, 2) with a checkpoint at step 4 (``ckpt_every=4``)
    and the final one at step 6 in ``ckpt_a``; rank 0 deletes step 6, as a
    crash after step 4 would leave the directory, and copies it to
    ``ckpt_b`` and ``ckpt_c`` before anything resumes; resumed to 6 steps
    on (2, 2) from ``ckpt_a`` and on (4, 1) from ``ckpt_b``. Each run's
    losses, grad norms and final parameters (whole, on the host)."""
    import shutil
    from repro_torch.launch.train import train
    kw = dict(steps=CKPT_STEPS, batch=CKPT_BATCH, seq=CKPT_SEQ,
              device="cpu", lr=LR, log_every=100, keep_state=True)
    dirs = {k: os.path.join(workdir, f"ckpt_{k}") for k in "abc"}

    def run(**more):
        res = train(CKPT_ARCH, **kw, **more)
        return {"losses": res["losses"], "gnorms": res["grad_norms"],
                "start": res["start_step"], "params": res["params"],
                "status": res["status"]}
    out = {"full": run(mesh_shape=(2, 2), ckpt_dir=dirs["a"],
                       ckpt_every=CKPT_AT)}
    if rank == 0:
        shutil.rmtree(os.path.join(dirs["a"], f"step_{CKPT_STEPS:08d}"))
        for k in "bc":
            shutil.copytree(dirs["a"], dirs[k])
    dist.barrier()
    out["same"] = run(mesh_shape=(2, 2), ckpt_dir=dirs["a"], resume=True)
    out["other"] = run(mesh_shape=(4, 1), ckpt_dir=dirs["b"], resume=True)
    return out


CASES = {"step": case_step, "misc": case_misc, "one": case_one,
         "serve": case_serve, "ckpt": case_ckpt}


def main():
    case, rank, world, store, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    init_file_group(store, rank, world, "cpu")
    try:
        mesh = make_mesh((2, 2) if world == 4 else (1, 1),
                         ("data", "model"), "cpu")
        out = CASES[case](rank, mesh, workdir)
        if rank == 0:
            with open(os.path.join(workdir, f"{case}.pkl"), "wb") as f:
                pickle.dump(tree_map(
                    lambda x: x.numpy() if isinstance(x, torch.Tensor)
                    else x, out), f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
