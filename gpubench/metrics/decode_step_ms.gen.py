"""Host milliseconds of a decode-loop step over the window (TorchModel.step_s / steps: the replay, its wait and the token copy)."""
from gpubench import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
