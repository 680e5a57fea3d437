"""The probe's bytes of a prefill at the mix's longest prompt over the bytes that prefill alone took on the card (set-up of the traced run)."""


def read(ctx):
    return ctx.probe_ratio
