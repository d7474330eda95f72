"""MLA's attention backward (kernel row 15: ``ops/mla_attention.py``'s
``MlaAttention.backward``), bound by its products at the bf16 peak over
the causal pairs and heads (twice the forward's; the recomputed products
not counted)."""

from bench_port import readers_dlrm
from bench_port.work.mla_moe import mla_attn_bwd


def read(res, ctx):
    return readers_dlrm.roofline(res, "mla_attn_bwd", mla_attn_bwd)
