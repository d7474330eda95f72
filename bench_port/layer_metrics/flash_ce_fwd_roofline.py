"""The retrieval loss's forward (``ops/flash_ce.py::flash_softmax_ce``)."""

from bench_port.readers import roofline


def read(res, ctx):
    return roofline(res, "flash_ce_fwd")
