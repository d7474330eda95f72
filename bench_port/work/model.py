"""Model FLOPs of the two-tower + DCN model, from the configuration.

Counted once, forward as a multiply-add = 2 operations, a backward as
twice its forward's products; nothing recomputed counts. ``mfu`` is these
FLOPs over the window's seconds and the card's bf16 dense peak.
"""

from __future__ import annotations

from typing import Dict, Sequence


def _mlp(dims: Sequence[int]) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def tower(model: Dict) -> float:
    """One tower's forward for one id: the MLP d -> dims -> d."""
    d = model["embedding_dim"]
    return _mlp([d, *model["user_tower_dims"], d])


def ranker(model: Dict) -> float:
    """DCN (cross stack, deep MLP) and both heads for one (user, item) pair."""
    f = 2 * model["embedding_dim"] + model.get("dense_features", 0)
    cross = model["cross_layers"] * 5 * f
    deep = _mlp([f, *model["dnn_dims"]])
    out = f + (model["dnn_dims"][-1] if model["dnn_dims"] else 0)
    return cross + deep + 2 * 2 * out


def serve_request(model: Dict, n_items: int, rerank: int) -> float:
    """One ``/recommend``: the user tower once, the cosine scores over the
    catalog (whose item embeddings the index holds), and the ranker over
    the ``rerank`` candidates."""
    d = model["embedding_dim"]
    return tower(model) + 2.0 * n_items * d + rerank * ranker(model)


def train_example(model: Dict, batch: int, n_candidates: int) -> float:
    """One training example: forward and backward (x3) of both towers and
    the ranker, and of the retrieval logits: the forward over all
    ``n_candidates`` columns, dU over them too, dV over the ``batch``
    in-batch columns only (cached candidates take no gradient)."""
    d = model["embedding_dim"]
    dense = 3.0 * (2 * tower(model) + ranker(model))
    logits = 2.0 * n_candidates * d + 2.0 * n_candidates * d + 2.0 * batch * d
    return dense + logits
