"""1 - (the union of the window's device intervals / the traced window)."""

from bench_port.readers import idle_share


def read(res, ctx):
    return idle_share(res)
