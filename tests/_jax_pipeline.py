"""The reference's pipeline under ``jax.grad`` on 4 host CPU devices: the
numbers ``tests/test_torch_dist.py`` holds the port's pipeline to.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_pipeline.py IN.pkl OUT.pkl

``IN.pkl`` holds the inputs (``w``, ``x`` of the tanh stack; reduced
gemma2-9b's 4 layers' parameters and hidden states); ``OUT.pkl`` gets y
and the gradients of the stage params and x, on an Auto mesh (``jax.grad``
through ``make_pipeline_forward`` fails on ``jax.make_mesh``'s default
Explicit one on jax 0.9.0, ROADMAP C23; the error is recorded too).
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs.registry import get_arch
from repro.dist.pipeline import make_pipeline_forward, stack_stage_params
from repro.models import layers as L
from repro.models import model as M


def tanh_layers(sp, h):
    h, _ = jax.lax.scan(lambda h, wl: (jnp.tanh(h @ wl), None), h, sp)
    return h


def grads(pipe, sp, x, loss):
    y = pipe(sp, x)
    gw, gx = jax.grad(lambda w, x: loss(pipe(w, x)), argnums=(0, 1))(sp, x)
    return jax.tree_util.tree_map(np.asarray, (y, gw, gx))


def main():
    src, dst = sys.argv[1:3]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    auto = jax.make_mesh((4,), ("stage",), axis_types=(AxisType.Auto,))
    w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])
    out = {}
    for n_micro in (4, 8):
        pipe = make_pipeline_forward(tanh_layers, auto, n_micro=n_micro)
        out[f"tanh{n_micro}"] = grads(pipe, stack_stage_params(w, 4), x,
                                      lambda y: (y ** 2).sum())

    cfg = dataclasses.replace(get_arch("gemma2-9b").reduced(), n_layers=4)
    h = jnp.asarray(inp["gemma_x"])
    positions = jnp.arange(h.shape[1])

    def attn_layers(sp, h):
        def body(h, xs):
            lp, j = xs
            a = M.attn_block(lp["attn"], L.rms_norm(h, lp["norm1"]), cfg,
                             positions=positions,
                             window=M._layer_window(cfg, j),
                             attn_impl="flash")
            h = h + a
            return h + L.mlp_apply(lp["mlp"], L.rms_norm(h, lp["norm2"]),
                                   cfg.mlp_act), None
        h, _ = jax.lax.scan(body, h, (sp, jnp.arange(2)))
        return h
    two = jax.make_mesh((2,), ("stage",), devices=jax.devices()[:2],
                        axis_types=(AxisType.Auto,))
    layers = jax.tree_util.tree_map(jnp.asarray, inp["gemma_params"]["layers"])
    pipe = make_pipeline_forward(attn_layers, two, n_micro=2)
    out["gemma"] = grads(pipe, stack_stage_params(layers, 2), h,
                         lambda y: (y ** 2).mean())

    # C23: the same gradient on jax.make_mesh's default (Explicit) mesh
    explicit = jax.make_mesh((4,), ("stage",))
    pipe = make_pipeline_forward(tanh_layers, explicit, n_micro=4)
    try:
        grads(pipe, stack_stage_params(w, 4), x, lambda y: (y ** 2).sum())
        out["explicit_error"] = None
    except ValueError as e:
        out["explicit_error"] = str(e)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
