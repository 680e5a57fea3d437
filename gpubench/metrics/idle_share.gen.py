"""Share of the traced window in which nothing ran on the device."""
from gpubench import readers


def read(ctx):
    return readers.idle_share(ctx)
