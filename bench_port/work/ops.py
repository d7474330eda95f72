"""Operations and bytes of each timed operation, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever an implementation reads again; the operations are those the
mathematics needs (multiply-adds count 2), with nothing recomputed. The
same counts hold whichever kernels implement the operation.
"""

from __future__ import annotations

from typing import Dict, Tuple


def topk(q: int, n: int, d: int, k: int) -> Tuple[float, float, str]:
    """Exact top-k of [q, d] fp32 queries against an [n, d] fp32 catalog:
    the q x n dot products; reads both operands, writes k fp32 scores and
    k int64 ids a query. -> (flops, bytes, precision)."""
    flops = 2.0 * q * n * d
    n_bytes = 4.0 * (q * d + n * d) + q * k * (4 + 8)
    return flops, n_bytes, "fp32"


def dcn_cross_fwd(n: int, f: int, layers: int) -> Tuple[float, float, str]:
    """The rank-1 cross stack's forward over [n, f] fp32 rows:
    ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``: a dot (2f), a scale, a
    bias add and a residual add (3f) per row and layer; reads x0, w and b,
    writes the output."""
    flops = float(layers) * n * 5 * f
    n_bytes = 4.0 * (2 * n * f + 2 * layers * f)
    return flops, n_bytes, "fp32"


def flash_ce_fwd(bq: int, bk: int, d: int, dtype: str) -> Tuple[float, float, str]:
    """Softmax cross-entropy of [bq, d] queries over [bk, d] candidates:
    the bq x bk logits; reads both operands (``dtype`` bytes a value), the
    fp32 column correction and the int32 ids of both sides and the
    positives, writes the fp32 per-row loss."""
    w = 2 if dtype == "bf16" else 4
    flops = 2.0 * bq * bk * d
    n_bytes = w * (bq + bk) * d + 4.0 * (bk + bk + bq + bq) + 4.0 * bq
    return flops, n_bytes, dtype


def flash_ce_bwd(bq: int, bk: int, d: int, dtype: str) -> Tuple[float, float, str]:
    """Its backward: dU = (P - Y) V and dV = (P - Y)^T U (2 x 2 bq bk d;
    the logits' recompute is not counted); reads both operands, the
    correction, ids, positives, lse and the incoming gradient, writes dU,
    dV (``dtype``) and the fp32 column gradient."""
    w = 2 if dtype == "bf16" else 4
    flops = 4.0 * bq * bk * d
    n_bytes = (2 * w * (bq + bk) * d + 4.0 * (bk + bk + bq + bq) + 4.0 * 2 * bq
               + 4.0 * bk)
    return flops, n_bytes, dtype


OPS = {"topk": topk, "dcn_cross_fwd": dcn_cross_fwd, "flash_ce_fwd": flash_ce_fwd,
       "flash_ce_bwd": flash_ce_bwd}


def op_work(name: str, shape: Dict[str, object]) -> Tuple[float, float, str]:
    """The counts of operation ``name`` at the shape a span recorded."""
    return OPS[name](**shape)
