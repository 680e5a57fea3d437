"""Served tokens a second: the prompt tokens of every prefill that finished in the window and every token emitted in it, over the window."""
from gpubench import readers


def read(ctx):
    return readers.window_tokens(ctx) / ctx.seconds
