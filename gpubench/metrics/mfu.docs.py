"""Model FLOPs (matrix products) of the tokens tokens_per_s counts, over the window, as a share of the bf16 peak."""
from gpubench import readers


def read(ctx):
    return readers.mfu(ctx)
