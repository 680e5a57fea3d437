"""The reference's six examples (``examples/*.py``) on the port. Each runs
as ``python -m repro_torch.examples.<name> [--device cpu]`` on the card
unless ``--device cpu`` asks for the CPU, raises where there is neither,
and its ``main(argv=None)`` returns what it prints:

  * ``quickstart``: lazy buffers, Alg. 1, probes on ``TensorSpec``s, MGB,
    the executor and the streaming ``Cluster``;
  * ``gang_placement``: gangs on a 2x4 topology, sim and live, shedding;
  * ``preemptive_cluster``: eviction against admission only, and a live
    cooperative checkpoint;
  * ``trace_viewer``: a traced, calibrated run with a device death,
    written as a Chrome trace;
  * ``shared_cluster``: six reduced models (train and prefill jobs, the
    four hand kernels) under MGB and SA, a device death and a fleet of 64
    requests;
  * ``train_100m``: a 115M-parameter dense LM trained at its full width
    with checkpoints and resume.

The scheduler's virtual devices all map onto the one card (or the CPU)
through ``Executor.device_map``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import torch


def cli(argv: Optional[Sequence[str]],
        ap: Optional[argparse.ArgumentParser] = None
        ) -> Tuple[argparse.Namespace, torch.device]:
    """Parse ``argv`` (None: the command line) with ``--device`` added.
    Returns the arguments and the device: the card unless ``--device cpu``;
    raises when there is no card and the CPU was not asked for."""
    ap = ap or argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        return args, torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "example on the CPU")
    return args, torch.device("cuda", 0)


def device_name(device: torch.device) -> str:
    """What a result names as the device it ran on."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
