"""Operations and bytes of HSTU and of its timed operations, from the
configuration and the shapes a span records.

As in ``work/model.py`` and ``work/dlrm.py``: a multiply-add counts 2
operations, a backward twice its forward's products, nothing recomputed
counts; each input byte is counted read once and each output byte written
once, whatever an implementation reads again. The attention's work is
counted over its causal pairs (sum n (n + 1) / 2 over the histories, the
program's counter): the two products a pair and head, 64 wide.
"""

from __future__ import annotations

from typing import Dict, Tuple

HEAD = 64


def forward_step(model: Dict, events: float, pairs: float, histories: float) -> float:
    """One step's forward over ``events`` events in ``histories`` histories
    with ``pairs`` causal pairs: each block's two linear layers a row (W_uvqk
    d x 4 H 64, W_o H 64 x d), the attention's two products a pair and
    head, and the sampled softmax's logits (1 + negatives) a supervised
    event."""
    d, w = model["embedding_dim"], model["hstu_heads"] * HEAD
    blocks = model["hstu_blocks"]
    linear = blocks * (2.0 * d * 4 * w + 2.0 * w * d) * events
    attention = blocks * 2 * (2.0 * HEAD) * model["hstu_heads"] * pairs
    loss = 2.0 * d * (1 + model["hstu_negatives"]) * (events - histories)
    return linear + attention + loss


def train_step(model: Dict, events: float, pairs: float, histories: float) -> float:
    """One step trained: its forward and backward (3 x the forward)."""
    return 3.0 * forward_step(model, events, pairs, histories)


def hstu_attn_fwd(events: int, pairs: int, heads: int, dqk: int,
                  dv: int) -> Tuple[float, float, str]:
    """Row 11: S = Q K^T and O = A V over the causal pairs, bf16 operands;
    reads q, k, v (bf16) and the int64 timestamps, writes o (fp32)."""
    flops = 2.0 * pairs * heads * (dqk + dv)
    n_bytes = events * (2.0 * heads * (2 * dqk + dv) + 8.0 + 4.0 * heads * dv)
    return flops, n_bytes, "bf16"


def hstu_attn_bwd(events: int, pairs: int, heads: int, dqk: int,
                  dv: int) -> Tuple[float, float, str]:
    """Row 12: twice the forward's products (dV, dA, dQ, dK), nothing
    recomputed counted; reads q, k, v and do (bf16) and the timestamps,
    writes dq, dk, dv (fp32)."""
    flops = 4.0 * pairs * heads * (dqk + dv)
    n_bytes = events * (2.0 * heads * (2 * dqk + 2 * dv) + 8.0 + 4.0 * heads * (2 * dqk + dv))
    return flops, n_bytes, "bf16"
