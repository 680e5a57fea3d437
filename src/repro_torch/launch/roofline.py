"""Three-term roofline of one traced step on the H100 (nothing runs).

Port of ``src/repro/launch/roofline.py``. Per (arch x shape x mesh):

    compute_s    = analytic FLOPs / (chips x peak FLOP/s of the step's
                   matmul dtype)
    memory_s     = per-device bytes accessed / HBM bandwidth
    collective_s = per-device collective link bytes / NVLink bandwidth

The reference reads these from XLA's compiled per-device program
(``cost_analysis``, the HLO text). The port counts them on the rank's own
program as ``launch/dryrun.py`` runs the DTensor step on fake shards over
a fake process group (``LocalCounts``): each op on the rank's shards, each
collective DTensor issues (``_c10d_functional``), with the shapes the rank
sees. ``collective_bytes`` sums each collective's operand and result bytes
under the reference's traffic factors (all-reduce 1.0 of op + result, which
is ring traffic of about 2S; all-gather and reduce-scatter 1.0, about S;
all-to-all and point-to-point 0.5) and names the kinds as the reference
does.

The card's constants (NVIDIA H100 80GB HBM3, SXM5, 700 W, NVIDIA's data
sheet): 989e12 dense bf16 FLOP/s on the tensor cores and 67e12 f32 FLOP/s
outside them, chosen by the step's matmul dtype; 3.35e12 B/s of HBM3;
450e9 B/s of NVLink 4 a direction per GPU. The collective term is a
one-link figure, as the reference's is: a 16-wide ``model`` axis spans two
8-GPU NVSwitch nodes, whose traffic crosses the slower inter-node network,
so the term is optimistic there (an H100 fleet model is ROADMAP A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.launch.flops import step_flops

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: NVIDIA's data sheet, dense rates
PEAK_FLOPS_BF16 = 989e12     # FLOP/s on the tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s a direction per GPU
HBM_BYTES = 80e9             # the card's memory, for the fit

_FACTOR = {"all-reduce": 1.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 0.5, "collective-permute": 0.5}

# the traced collectives (``torch.ops._c10d_functional`` and c10d's
# point-to-point ops), by the reference's HLO kind names
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak for matrix products in ``dtype``."""
    return PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS_BF16


def op_kind(func) -> Optional[str]:
    """The reference's kind name of a collective op, or None."""
    if getattr(func, "namespace", None) not in ("_c10d_functional", "c10d"):
        return None
    return _KINDS.get(func._opname)


def group_name(args) -> Optional[str]:
    """The process group's name among a collective's arguments."""
    for a in reversed(args):
        if isinstance(a, str):
            return a
    return None


def collective_bytes(collectives) -> Dict[str, float]:
    """Per-device collective traffic bytes by kind from a rank's
    collectives (``launch.dryrun.LocalCounts.collectives``: kind, axis,
    shapes, operand + result bytes), each times its kind's factor."""
    out: Dict[str, float] = {}
    for kind, _, _, _, nbytes in collectives:
        out[kind] = out.get(kind, 0.0) + nbytes * _FACTOR[kind]
    return out


@dataclasses.dataclass
class Roofline:
    hlo_flops_per_device: float  # the rank's counted program (every op)
    analytic_flops_global: float  # repro_torch.launch.flops: the compute term
    bytes_per_device: float
    collective_per_device: float
    coll_breakdown: Dict[str, float]
    peak_mem_per_device: float
    chips: int
    model_flops: float           # 6*N_active*tokens (train) / 2*N_active*tokens
    peak_flops: float = PEAK_FLOPS_BF16  # of the step's matmul dtype
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / analytic FLOPs
    roofline_fraction: float = 0.0  # useful compute time / max(term)

    def finalize(self) -> "Roofline":
        self.compute_s = self.analytic_flops_global / (self.chips
                                                       * self.peak_flops)
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_per_device / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / self.analytic_flops_global
                             if self.analytic_flops_global else 0.0)
        # fraction of roofline: time the USEFUL model flops would take at
        # peak vs. the bounding term of the counted program
        useful_s = self.model_flops / (self.chips * self.peak_flops)
        bound = max(terms.values())
        self.roofline_fraction = useful_s / bound if bound else 0.0
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs: 6*N_active*D (train), 2*N_active*D (inference)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def analyze(counts: Dict[str, float], coll: Dict[str, float], cfg, shape,
            chips: int, dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The roofline of a traced step: ``counts`` from
    ``core.probe.trace_counts`` over its local program, ``coll`` its
    ``collective_bytes``; the peak is the arguments plus the traced live
    peak."""
    return Roofline(
        hlo_flops_per_device=float(counts["flops"]),
        analytic_flops_global=step_flops(cfg, shape),
        bytes_per_device=float(counts["bytes_accessed"]),
        collective_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        peak_mem_per_device=float(counts["arg_bytes"]
                                  + counts["peak_live_bytes"]),
        chips=chips,
        model_flops=model_flops(cfg, shape),
        peak_flops=peak_flops(dtype),
    ).finalize()
