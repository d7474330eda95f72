"""The retrieval loss's backward (``FlashSoftmaxCE.backward``, whatever
kernels implement it), without the logits' recompute."""

from bench_port.readers import roofline


def read(res, ctx):
    return roofline(res, "flash_ce_bwd")
