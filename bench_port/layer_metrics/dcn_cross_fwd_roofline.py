"""The rerank's cross stack (``models/dcn.py::cross_stack`` forward)."""

from bench_port.readers import roofline


def read(res, ctx):
    return roofline(res, "dcn_cross_fwd")
