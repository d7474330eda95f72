"""Ranking metrics over ranked id lists, one relevant item per row (a copy
of ``recsys_tpu/retrieval/metrics.py``, numpy only).

``ndcg_at_k`` keeps the reference's idcg = 1 quirk: ndcg is
``1 / log2(rank + 2)`` for a hit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _ranks(predictions: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """0-based rank of the true item in each prediction row; -1 = miss."""
    hits = predictions == truth[:, None]
    return np.where(hits.any(axis=1), hits.argmax(axis=1), -1)


class RankingMetrics:
    @staticmethod
    def recall_at_k(predictions: np.ndarray, truth: np.ndarray, k: int) -> float:
        return float((_ranks(predictions[:, :k], truth) >= 0).mean())

    @staticmethod
    def precision_at_k(predictions: np.ndarray, truth: np.ndarray, k: int) -> float:
        return float((_ranks(predictions[:, :k], truth) >= 0).mean() / k)

    @staticmethod
    def ndcg_at_k(predictions: np.ndarray, truth: np.ndarray, k: int) -> float:
        r = _ranks(predictions[:, :k], truth)
        dcg = np.where(r >= 0, 1.0 / np.log2(np.maximum(r, 0) + 2.0), 0.0)
        return float(dcg.mean())  # idcg == 1 (the reference's quirk)

    @staticmethod
    def map_at_k(predictions: np.ndarray, truth: np.ndarray, k: int) -> float:
        r = _ranks(predictions[:, :k], truth)
        return float(np.where(r >= 0, 1.0 / (np.maximum(r, 0) + 1.0), 0.0).mean())

    @staticmethod
    def mrr(predictions: np.ndarray, truth: np.ndarray) -> float:
        r = _ranks(predictions, truth)
        return float(np.where(r >= 0, 1.0 / (np.maximum(r, 0) + 1.0), 0.0).mean())

    @staticmethod
    def coverage(predictions: np.ndarray, catalog_size: int) -> float:
        return float(len(np.unique(predictions)) / max(catalog_size, 1))

    @staticmethod
    def diversity(predictions: np.ndarray) -> float:
        k = predictions.shape[1]
        uniq = np.array([len(np.unique(row)) for row in predictions])
        return float((uniq / k).mean())

    @staticmethod
    def full_report(predictions: np.ndarray, truth: np.ndarray,
                    topk: Sequence[int] = (5, 10, 20, 50),
                    catalog_size: int = 0) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k in topk:
            kk = min(k, predictions.shape[1])
            out[f"recall@{k}"] = RankingMetrics.recall_at_k(predictions, truth, kk)
            out[f"precision@{k}"] = RankingMetrics.precision_at_k(predictions, truth, kk)
            out[f"ndcg@{k}"] = RankingMetrics.ndcg_at_k(predictions, truth, kk)
            out[f"map@{k}"] = RankingMetrics.map_at_k(predictions, truth, kk)
        out["mrr"] = RankingMetrics.mrr(predictions, truth)
        if catalog_size:
            out["coverage"] = RankingMetrics.coverage(predictions, catalog_size)
        out["diversity"] = RankingMetrics.diversity(predictions)
        return out
