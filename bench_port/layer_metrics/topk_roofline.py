"""Exact top-k (``retrieval/scorer.py::exact_topk``): its work at the
published peaks over the device time of everything launched under it."""

from bench_port.readers import roofline


def read(res, ctx):
    return roofline(res, "topk")
