"""The low-rank cross layers' forward (``models/dcn.py::low_rank_cross_stack``),
bound by its products at the bf16 peak."""

from bench_port import readers_dlrm
from bench_port.work.dlrm import dcnv2_cross_fwd


def read(res, ctx):
    return readers_dlrm.roofline(res, "dcnv2_cross_fwd", dcnv2_cross_fwd)
