"""Offline evaluator: the full metric report of one split on the device
(the counterpart of ``recsys_tpu/retrieval/evaluator.py``): recall,
precision, ndcg, map at each k, mrr, coverage, diversity through the
port's exact top-k, plus rating RMSE and CTR AUC through the model's
heads.

Seen-item filtering (``EvalConfig.filter_seen``) and ``two_stage_evaluate``
are not ported yet and raise: their over-retrieve branch asks for
k + max_seen candidates, which can exceed the top-k kernel's 256
(ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from recsys_tpu_torch.config import EvalConfig, ModelConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.retrieval.metrics import RankingMetrics
from recsys_tpu_torch.retrieval.scorer import exact_topk, materialize_item_embeddings


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to recsys_tpu_torch yet (ROADMAP Queue 1: item 6, "
        "evaluation: the over-retrieve branch can exceed k = 256)")


@torch.no_grad()
def evaluate(params: Dict, cfg: ModelConfig, bundle: Dict[str, np.ndarray],
             split: str = "val", eval_cfg: EvalConfig = EvalConfig(), seed: int = 42,
             dense: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Full metric report for one split, computed on the device the
    params lie on. ``eval_sample`` draws that many rows with numpy's
    ``default_rng(seed)``, as the JAX package does."""
    if cfg.dense_features > 0 or dense is not None:
        raise NotImplementedError(
            "dense features are not ported to recsys_tpu_torch yet "
            "(ROADMAP Queue 1: item 4, data and features)")
    if eval_cfg.filter_seen:
        _not_ported("evaluate(filter_seen=True)")
    uid = bundle[f"{split}/user_id"]
    mid = bundle[f"{split}/movie_id"]
    rating = bundle[f"{split}/rating"]
    y = bundle[f"{split}/y_implicit"]
    n_items = int(bundle["meta/n_movies"])
    if eval_cfg.eval_sample and len(uid) > eval_cfg.eval_sample:
        idx = np.random.default_rng(seed).choice(len(uid), eval_cfg.eval_sample,
                                                 replace=False)
        uid, mid, rating, y = uid[idx], mid[idx], rating[idx], y[idx]

    towers = params["towers"]
    device = towers["item_table"].device
    item_embs = materialize_item_embeddings(towers, cfg, n_items)
    use_cosine = eval_cfg.score_norm == "cosine"
    item_bias = None
    if not use_cosine and "item_bias" in towers:
        item_bias = towers["item_bias"][:n_items].detach()
    max_k = max(eval_cfg.topk)
    bs = eval_cfg.eval_batch_size
    preds_list, rat_list, ctr_list = [], [], []
    for lo in range(0, len(uid), bs):
        u_ids = torch.as_tensor(uid[lo:lo + bs], device=device).long()
        m_ids = torch.as_tensor(mid[lo:lo + bs], device=device).long()
        u_emb = TwoTower.user_embed(towers, u_ids, cfg)
        _, top_ids = exact_topk(u_emb, item_embs, max_k, normalize=use_cosine,
                                item_bias=item_bias)
        out = MultiTaskModel.apply(params, cfg, u_ids, m_ids)
        preds_list.append(top_ids[:, :max_k].cpu().numpy())
        rat_list.append(out.rating_pred.cpu().numpy())
        ctr_list.append(torch.sigmoid(out.ctr_logit).cpu().numpy())

    preds = np.concatenate(preds_list)
    report = RankingMetrics.full_report(preds, mid, topk=eval_cfg.topk,
                                        catalog_size=n_items)
    r_pred = np.concatenate(rat_list)
    c_pred = np.concatenate(ctr_list)
    report["rating_rmse"] = float(np.sqrt(np.mean((r_pred - rating) ** 2)))
    if 0 < y.sum() < len(y):
        report["ctr_auc"] = _auc_host(c_pred, y)
    return report


def two_stage_evaluate(*args, **kwargs):
    _not_ported("two_stage_evaluate")


def _auc_host(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-sum ROC-AUC in float64 with midranks for ties."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels) >= 0.5
    order = np.argsort(scores)
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_s = scores[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
