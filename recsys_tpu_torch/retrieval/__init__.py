"""Retrieval layer: exact on-device scoring and top-k over the catalog."""

from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, exact_topk, topk_scores

__all__ = ["RetrievalIndex", "exact_topk", "topk_scores"]
