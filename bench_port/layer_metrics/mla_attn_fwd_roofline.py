"""MLA's attention forward (kernel row 14: ``ops/mla_attention.py``'s
``mla_attention`` on the card), bound by its products at the bf16 peak
over the causal pairs and heads (192 + 128 wide)."""

from bench_port import readers_dlrm
from bench_port.work.mla_moe import mla_attn_fwd


def read(res, ctx):
    return readers_dlrm.roofline(res, "mla_attn_fwd", mla_attn_fwd)
