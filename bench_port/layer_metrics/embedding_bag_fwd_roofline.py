"""The pooled multi-hot lookup (``ops/embedding_bag.py::bag_forward``),
bound by bytes: the touched rows (the program's counter), the ids and the
bags written."""

from bench_port import readers_dlrm
from bench_port.work.dlrm import embedding_bag_fwd


def read(res, ctx):
    u = readers_dlrm.unique_rows(res)
    if u is None:
        return None
    return readers_dlrm.roofline(res, "embedding_bag_fwd", embedding_bag_fwd, unique_rows=u)
