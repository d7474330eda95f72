"""Offline evaluator: the full metric report of one split on the device
(the counterpart of ``recsys_tpu/retrieval/evaluator.py``): recall,
precision, ndcg, map at each k, mrr, coverage, diversity through the
port's top-k, plus rating RMSE and CTR AUC through the model's heads,
and ``two_stage_evaluate``, which scores retrieval followed by the DCN
rerank.

Seen-item filtering (``EvalConfig.filter_seen``) keeps the JAX
package's two branches: a per-batch [B, N] seen mask while B * N stays
under ``_BATCH_MASK_LIMIT``, else retrieve k + max_seen candidates with
the exact top-k (the blockwise scan once the dense scores would pass
``scorer._DENSE_SCORES_CAP``) and drop the seen ones on the host.

A model with engineered dense features (``ModelConfig.dense_features >
0``) takes the split's feature matrix (``evaluate(dense=...)``) or a
fitted engineer (``two_stage_evaluate(engineer=...)``); without them both
fit the engineer from the bundle, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from recsys_tpu_torch.config import EvalConfig, ModelConfig
from recsys_tpu_torch.data.features import make_engineer
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops.topk_flash import NEG_INF, l2_normalize
from recsys_tpu_torch.retrieval.metrics import RankingMetrics
from recsys_tpu_torch.retrieval.scorer import exact_topk, materialize_item_embeddings


class SeenIndex:
    """Per-user sorted seen-item lists in CSR form (a numpy copy of the
    JAX package's): O(nnz) memory, never the [n_users, n_items] mask.

    Filtering happens after retrieval: retrieve ``k + max_seen``
    candidates (so k unseen survivors are guaranteed), then drop each
    row's seen hits with one ``searchsorted`` over (user, item) int64
    keys; or, for small catalogs, mask one batch densely."""

    def __init__(self, user_ids: np.ndarray, item_ids: np.ndarray,
                 n_users: int, n_items: int):
        u = np.asarray(user_ids, np.int64)
        i = np.asarray(item_ids, np.int64)
        order = np.lexsort((i, u))
        self.n_items = int(n_items)
        self.keys = u[order] * self.n_items + i[order]  # sorted
        # CSR view for per-batch masks (items sorted within user)
        self.items = i[order].astype(np.int32)
        counts = np.bincount(u, minlength=n_users)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.max_seen = int(counts.max()) if len(counts) else 0

    def batch_mask(self, user_ids: np.ndarray) -> np.ndarray:
        """Dense bool mask [B, n_items] for one batch of users."""
        users = np.asarray(user_ids, np.int64)
        mask = np.zeros((len(users), self.n_items), bool)
        # one scatter per unique user, applied to all its rows at once
        uniq, inv = np.unique(users, return_inverse=True)
        for j, u in enumerate(uniq):
            su = self.items[self.indptr[u]:self.indptr[u + 1]]
            if len(su):
                mask[np.nonzero(inv == j)[0][:, None], su] = True
        return mask

    def contains(self, user_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """Elementwise (broadcast) membership: True where (user, item) was seen."""
        q = (np.asarray(user_ids, np.int64) * self.n_items
             + np.asarray(item_ids, np.int64))
        if not len(self.keys):
            return np.zeros(q.shape, bool)
        pos = np.minimum(np.searchsorted(self.keys, q), len(self.keys) - 1)
        return self.keys[pos] == q

    def filter_topk(self, user_ids: np.ndarray, cand_ids: np.ndarray,
                    k: int, cand_scores: Optional[np.ndarray] = None):
        """Keep each row's first ``k`` unseen candidates, in score order.
        ``cand_ids`` [B, k'] with k' >= k + max_seen. -> ids [B, k] (and
        their scores when given)."""
        seen = self.contains(np.asarray(user_ids)[:, None], cand_ids)
        # stable sort on the seen flag: unseen first, order kept within
        order = np.argsort(seen, axis=1, kind="stable")[:, :k]
        ids = np.take_along_axis(cand_ids, order, axis=1)
        if cand_scores is None:
            return ids
        return ids, np.take_along_axis(cand_scores, order, axis=1)


def _topk_batch_masked(user_emb: torch.Tensor, item_embs: torch.Tensor,
                       mask: torch.Tensor, k: int, normalize: bool = True,
                       item_bias: Optional[torch.Tensor] = None):
    """Top-k with one batch's [B, N] seen mask: dense scores (a library
    product, at most ``_BATCH_MASK_LIMIT`` of them), seen items at
    ``NEG_INF``. -> (scores [B, k], ids [B, k])."""
    u, v = user_emb, item_embs
    if normalize:
        u, v = l2_normalize(u), l2_normalize(v)
    scores = torch.matmul(u, v.T)
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    return torch.topk(scores.masked_fill(mask, NEG_INF), k, dim=1)


# per-batch mask against over-retrieval: up to this B * N the dense mask
# and a small-k top-k; above it, k + max_seen candidates (the JAX
# package's crossover)
_BATCH_MASK_LIMIT = 1 << 29


def _filtered_topk(u_emb, item_embs, u_ids, seen_index: SeenIndex, k: int, bs: int,
                   n_items: int, use_cosine: bool, item_bias) -> np.ndarray:
    """Seen-filtered top-k ids [B, k] of one batch."""
    if bs * n_items <= _BATCH_MASK_LIMIT:
        mask = torch.as_tensor(seen_index.batch_mask(u_ids), device=u_emb.device)
        _, top = _topk_batch_masked(u_emb, item_embs, mask, k, normalize=use_cosine,
                                    item_bias=item_bias)
        return top.cpu().numpy()
    retrieve_k = min(k + seen_index.max_seen, n_items)
    _, cand = exact_topk(u_emb, item_embs, retrieve_k, normalize=use_cosine,
                         item_bias=item_bias)
    return seen_index.filter_topk(u_ids, cand.cpu().numpy(), k)


@torch.no_grad()
def evaluate(params: Dict, cfg: ModelConfig, bundle: Dict[str, np.ndarray],
             split: str = "val", eval_cfg: EvalConfig = EvalConfig(), seed: int = 42,
             dense: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Full metric report for one split, computed on the device the
    params lie on. ``eval_sample`` draws that many rows with numpy's
    ``default_rng(seed)``, as the JAX package does. ``dense``: the split's
    engineered feature matrix [N, F] for a model with
    ``cfg.dense_features > 0`` (fitted here from the bundle when None)."""
    uid = bundle[f"{split}/user_id"]
    mid = bundle[f"{split}/movie_id"]
    rating = bundle[f"{split}/rating"]
    y = bundle[f"{split}/y_implicit"]
    n_items = int(bundle["meta/n_movies"])
    if cfg.dense_features > 0 and dense is None:
        dense = make_engineer(bundle, cfg.dense_features).fit_transform_splits(bundle)[split]
    if eval_cfg.eval_sample and len(uid) > eval_cfg.eval_sample:
        idx = np.random.default_rng(seed).choice(len(uid), eval_cfg.eval_sample,
                                                 replace=False)
        uid, mid, rating, y = uid[idx], mid[idx], rating[idx], y[idx]
        if dense is not None:
            dense = dense[idx]

    # seen-item filtering: with a temporal holdout the user's next item
    # is not among their train items, so scoring seen items only measures
    # re-recommendation (off by default, as in the reference)
    seen_index = None
    if eval_cfg.filter_seen:
        seen_index = SeenIndex(bundle["train/user_id"], bundle["train/movie_id"],
                               int(bundle["meta/n_users"]), n_items)

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
        if seen_index is None:
            top_ids = exact_topk(u_emb, item_embs, max_k, normalize=use_cosine,
                                 item_bias=item_bias)[1].cpu().numpy()
        else:
            top_ids = _filtered_topk(u_emb, item_embs, uid[lo:lo + bs], seen_index,
                                     max_k, bs, n_items, use_cosine, item_bias)
        d_rows = None
        if dense is not None:
            d_rows = torch.as_tensor(dense[lo:lo + bs], device=device)
        out = MultiTaskModel.apply(params, cfg, u_ids, m_ids, dense=d_rows)
        preds_list.append(top_ids[:, :max_k])
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


@torch.no_grad()
def two_stage_evaluate(params: Dict, cfg: ModelConfig, bundle: Dict[str, np.ndarray],
                       split: str = "val", n_cand: int = 200, ctr_weight: float = 0.25,
                       topk: int = 10, max_rows: int = 8192, engineer=None,
                       seed: int = 42, rating_weight: float = 0.0) -> Dict[str, float]:
    """Offline two-stage eval on the device the params lie on: seen-filtered
    retrieval of ``n_cand`` candidates (raw dot + item bias), then the
    rerank by ``retrieval score + ctr_weight * CTR logit (+ rating_weight
    * rating)`` through the full model (the DCN cross-stack kernel on the
    card), then recall and ndcg at ``topk`` of the reranked list, over the
    split's first ``max_rows`` rows. ``engineer``: the fitted
    ``FeatureEngineer`` of a model with ``cfg.dense_features > 0`` (fitted
    here from the bundle when None); each candidate's features are taken
    at its row's timestamp. ``seed`` is the JAX signature's."""
    del seed
    n_items = int(bundle["meta/n_movies"])
    uid = bundle[f"{split}/user_id"][:max_rows]
    mid = bundle[f"{split}/movie_id"][:max_rows]
    if cfg.dense_features > 0:
        ts = bundle[f"{split}/timestamp"][:max_rows].astype(np.float64)
        if engineer is None:
            engineer = make_engineer(bundle, cfg.dense_features)
            engineer.fit_transform_splits(bundle)  # fits the stats and the train scaler
    towers = params["towers"]
    device = towers["item_table"].device
    item_embs = materialize_item_embeddings(towers, cfg, n_items)
    item_bias = towers["item_bias"][:n_items].detach()
    seen_index = SeenIndex(bundle["train/user_id"], bundle["train/movie_id"],
                           int(bundle["meta/n_users"]), n_items)
    bs = 2048
    use_batch_mask = bs * n_items <= _BATCH_MASK_LIMIT
    retrieve_k = min(n_cand + seen_index.max_seen, n_items)
    preds = []
    for lo in range(0, len(uid), bs):
        chunk = uid[lo:lo + bs]
        u_ids = torch.as_tensor(chunk, device=device).long()
        u_emb = TwoTower.user_embed(towers, u_ids, cfg)
        if use_batch_mask:
            mask = torch.as_tensor(seen_index.batch_mask(chunk), device=device)
            cand_scores, cand = _topk_batch_masked(u_emb, item_embs, mask, n_cand,
                                                   normalize=False, item_bias=item_bias)
        else:
            scores, cand = exact_topk(u_emb, item_embs, retrieve_k, normalize=False,
                                      item_bias=item_bias)
            ids, sc = seen_index.filter_topk(chunk, cand.cpu().numpy(), n_cand,
                                             scores.cpu().numpy())
            cand_scores = torch.as_tensor(sc, device=device)
            cand = torch.as_tensor(ids, device=device)
        d_rows = None
        if cfg.dense_features > 0:
            d_rows = torch.as_tensor(engineer.transform_scaled(
                np.repeat(chunk, n_cand), cand.reshape(-1).cpu().numpy(),
                np.repeat(ts[lo:lo + bs], n_cand)), device=device)
        out = MultiTaskModel.apply(params, cfg, u_ids.repeat_interleave(n_cand),
                                   cand.reshape(-1), dense=d_rows)
        combined = cand_scores + ctr_weight * out.ctr_logit.reshape(-1, n_cand)
        if rating_weight:
            combined = combined + rating_weight * out.rating_pred.reshape(-1, n_cand)
        order = torch.argsort(-combined, dim=1, stable=True)
        preds.append(torch.gather(cand, 1, order).cpu().numpy())
    preds = np.concatenate(preds)
    return {
        f"two_stage_recall@{topk}": RankingMetrics.recall_at_k(preds[:, :topk], mid, topk),
        f"two_stage_ndcg@{topk}": RankingMetrics.ndcg_at_k(preds[:, :topk], mid, topk),
        "two_stage_candidates": n_cand,
        "two_stage_ctr_weight": ctr_weight,
    }


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
