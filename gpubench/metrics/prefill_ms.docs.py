"""Median BEGIN -> END of the window's prefill tasks (the engine's Tracer)."""
from gpubench import readers


def read(ctx):
    return readers.prefill_ms(ctx)
