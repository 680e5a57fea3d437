"""Mean rows in use in the decode loop, sampled before every pump."""


def read(ctx):
    return sum(ctx.pump_rows) / len(ctx.pump_rows) if ctx.pump_rows else None
