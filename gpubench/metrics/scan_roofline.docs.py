"""Roofline share of the selective scan's forward (``repro_torch::mamba_scan``)
over its launches in the traced window: the bytes bound of each launch's
[B, S, E, N] against the device time of its kernels."""
from gpubench import readers, roofline


def read(ctx):
    return readers.op_roofline(
        ctx, "repro_torch::mamba_scan",
        lambda shapes, dtypes: roofline.scan_bound_s(shapes[0]))
