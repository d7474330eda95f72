"""Operations and bytes of MLA-MoE (``models/mla_moe.py``) and of its timed
operations (kernel rows 14 to 16), from the configuration and the
program's counters of a step.

As in ``work/hstu.py``: a multiply-add counts 2 operations, a backward
twice its forward's products, nothing recomputed counts; each input byte
is counted read once and each output byte written once, whatever an
implementation reads again. The attention's work is counted over its
causal pairs (sum n (n + 1) / 2 over the histories, the program's
counter), the routed experts' over the (token, expert) pairs on this
card's experts (``moe_assignments``, summed over the MoE layers), the
padding rows of the experts' tiles not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple


def forward_step(model: Dict, events: float, pairs: float, histories: float,
                 assignments: float) -> float:
    """One step's forward: each layer's MLA projections a row (W_q d x H
    (nope + rope), W_kv_a d x (kv + rope), W_kv_b kv x H (nope + v), W_o H v
    x d) and its attention's two products a pair and head; the dense
    layers' SwiGLU (3 products of d x width) a row; each MoE layer's router
    (d x X) and shared experts (3 products of d x shared width) a row and
    the routed experts' 3 products of d x width a pair on a held expert;
    the sampled softmax's logits (1 + negatives) a supervised event."""
    d, h = model["embedding_dim"], model["mla_heads"]
    nope, rope, vd, kv = (model["mla_nope_dim"], model["mla_rope_dim"], model["mla_v_dim"],
                          model["mla_kv_rank"])
    layers, dense = model["mla_layers"], model["mla_dense_layers"]
    proj = 2.0 * (d * h * (nope + rope) + d * (kv + rope) + kv * h * (nope + vd) + h * vd * d)
    attn = 2.0 * h * (nope + rope + vd) * pairs
    mla = layers * (proj * events + attn)
    ffn = dense * 6.0 * d * model["mla_dense_width"] * events
    moe_layers = layers - dense
    shared = moe_layers * (2.0 * d * model["moe_experts"]
                           + 6.0 * d * model["moe_shared"] * model["moe_width"]) * events
    routed = 6.0 * d * model["moe_width"] * assignments
    loss = 2.0 * d * (1 + model["hstu_negatives"]) * (events - histories)
    return mla + ffn + shared + routed + loss


def train_step(model: Dict, events: float, pairs: float, histories: float,
               assignments: float) -> float:
    """One step trained: its forward and backward (3 x the forward)."""
    return 3.0 * forward_step(model, events, pairs, histories, assignments)


def mla_attn_fwd(events: int, pairs: int, heads: int, dqk: int,
                 dv: int) -> Tuple[float, float, str]:
    """Row 14: S = Q K^T and O = P V over the causal pairs, bf16 operands;
    reads q, k (bf16, dqk a head), v (bf16), writes o (fp32) and the
    logsumexp (fp32)."""
    flops = 2.0 * pairs * heads * (dqk + dv)
    n_bytes = events * heads * (2.0 * (2 * dqk + dv) + 4.0 * dv + 4.0)
    return flops, n_bytes, "bf16"


def mla_attn_bwd(events: int, pairs: int, heads: int, dqk: int,
                 dv: int) -> Tuple[float, float, str]:
    """Row 15: twice the forward's products (dP, dV, dQ, dK), nothing
    recomputed counted; reads q, k, v and do (bf16), the logsumexp and
    delta (fp32), writes dq, dk, dv (fp32)."""
    flops = 4.0 * pairs * heads * (dqk + dv)
    n_bytes = events * heads * (2.0 * (2 * dqk + 2 * dv) + 8.0 + 4.0 * (2 * dqk + dv))
    return flops, n_bytes, "bf16"


def moe_experts(pairs: int, d: int, width: int, direction: str) -> Tuple[float, float, str]:
    """The routed experts of one MoE layer over ``pairs`` (token, held
    expert) pairs: 3 products of d x width a pair forward (gate, up,
    down), twice that backward; forward reads each pair's row (bf16) and
    writes its output (fp32), backward reads the incoming gradient (fp32)
    and the rows a backward that saved them would read (the bf16 input,
    the fp32 gate and up, the bf16 hidden; the program recomputes them,
    which counts nothing) and writes the input's gradient (fp32); the held
    experts'
    weights are read once a call and their gradients written once (not
    counted: a fixed 3 d width G values a call, under 1% of the rows at
    the cell's shape)."""
    flops = 6.0 * pairs * d * width * (1 if direction == "fwd" else 2)
    if direction == "fwd":
        n_bytes = pairs * (2.0 * d + 4.0 * d)
    else:
        n_bytes = pairs * (4.0 * d + 2.0 * d + 8.0 * width + 2.0 * width + 4.0 * d)
    return flops, n_bytes, "bf16"
