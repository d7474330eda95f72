"""``torch.cuda.max_memory_allocated()`` over the run, in GiB."""

from bench_port.readers import peak_gib


def read(res, ctx):
    return peak_gib(res)
