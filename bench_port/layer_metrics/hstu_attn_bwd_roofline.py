"""HSTU's attention backward (kernel row 12: ``ops/hstu_attention.py``'s
``HstuAttention.backward``), bound by its products at the bf16 peak over
the causal pairs (twice the forward's; the recomputed products not
counted)."""

from bench_port import readers_dlrm
from bench_port.work.hstu import hstu_attn_bwd


def read(res, ctx):
    return readers_dlrm.roofline(res, "hstu_attn_bwd", hstu_attn_bwd)
