"""HSTU's attention forward (kernel row 11: ``ops/hstu_attention.py``'s
``hstu_attention`` on the card), bound by its products at the bf16 peak
over the causal pairs."""

from bench_port import readers_dlrm
from bench_port.work.hstu import hstu_attn_fwd


def read(res, ctx):
    return readers_dlrm.roofline(res, "hstu_attn_fwd", hstu_attn_fwd)
