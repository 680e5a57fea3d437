"""End-to-end example: train a ~100M-parameter dense LM for a few hundred
steps on the synthetic pipeline, with checkpointing + resume.

Real data pipeline -> train step (the hand flash attention and RMSNorm
kernels, forward and backward, on a card) -> AdamW -> async checkpoints,
the loss demonstrably decreasing, at the model's full width and depth in
f32.

Port of ``examples/train_100m.py``. What differs:

  * the run goes through ``repro_torch.launch.train.train``, which trains
    unsharded as one task under the scheduler; the reference's launcher
    always builds a mesh, and on one device its step fails in the
    embedding gather (ROADMAP C2, C26), so the reference example does not
    run where this one does;
  * attention is the hand kernel (``attn_impl="flash_kernel"``, the
    reference asks for its ``flash``);
  * a ``--resume`` that finds the run's last step already in
    ``--ckpt-dir`` restores it, runs no step and says so, where the
    reference's loss check fails on an empty run;
  * ``--ckpt-dir`` defaults to ``repro_torch_100m_ckpt`` under the
    temporary directory (``TMPDIR``, else ``/tmp``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--device cpu] \\
        [--steps 300] [--resume]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.examples import cli, device_name
from repro_torch.launch import train as T

# ~100M params: 2*V*d + L*(4*d^2 + 3*d*f) = 2*32000*640 + 12*(4*640^2 +
# 3*640*2560) ≈ 41M + 12*6.6M ≈ 120M
CONFIG_100M = ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=2560,
    vocab=32000,
    mlp_act="silu_gated",
    remat_policy="nothing",
)
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt")


def main(argv=None) -> dict:
    """Returns ``launch.train.train``'s result (``losses``, ``step_ms``,
    ``start_step``, ``checkpoint``, ...)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    args, device = cli(argv, ap)

    print(f"lm-100m: {CONFIG_100M.param_count() / 1e6:.0f}M params")
    registry.ARCHS[CONFIG_100M.name] = CONFIG_100M  # selectable config
    res = T.train(CONFIG_100M.name, steps=args.steps, batch=args.batch,
                  seq=args.seq, reduced=False, device=args.device,
                  ckpt_dir=args.ckpt_dir, ckpt_every=50, resume=args.resume,
                  attn_impl="flash_kernel", log_every=20, lr=1e-3)
    if not res["losses"]:
        print(f"resumed at step {res['start_step']} of {args.steps}: no "
              f"step left to run")
        return res
    first, last = res["losses"][0], res["final_loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {res['steps']} steps "
          f"({res['steps'] / res['wall_s']:.2f} steps/s on "
          f"{device_name(device)})")
    assert last < first, "loss must decrease"
    print("train_100m OK")
    return res


if __name__ == "__main__":
    main()
