"""The bags' backward, the rows' combine and the row-wise Adagrad update
(``ops/embedding_bag.py::bag_backward_rowwise_adagrad``, its sort
included), bound by bytes: the bags' gradient and the ids read, each
touched row and its accumulator read and written."""

from bench_port import readers_dlrm
from bench_port.work.dlrm import sparse_update


def read(res, ctx):
    u = readers_dlrm.unique_rows(res)
    if u is None:
        return None
    return readers_dlrm.roofline(res, "sparse_update", sparse_update, unique_rows=u)
