"""Roofline share of RMSNorm's forward (``repro_torch::rmsnorm``) over its
eager launches in the traced window (a replayed decode step's launches
carry no shapes, so they are not counted): each launch's bytes bound at its
rows and dtype against the device time of its kernels."""
from gpubench import readers, roofline


def read(ctx):
    return readers.op_roofline(
        ctx, "repro_torch::rmsnorm",
        lambda shapes, dtypes: roofline.rmsnorm_bound_s(
            shapes[0], readers.element_bytes(dtypes[0])))
