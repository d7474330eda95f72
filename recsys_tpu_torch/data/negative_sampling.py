"""Explicit negative sampling (random / hard / mixed / mined) and the
mining of true hard negatives from a trained index (the counterpart of
``recsys_tpu/data/negative_sampling.py``).

``NegativeSampler`` is numpy only and makes the same draws, from the same
``np.random.default_rng(seed)`` calls in the same order, as the JAX
package's, so both give the same negatives bit for bit:

* ``random``: uniform ids; ``hard``: the most popular items the user has
  not seen; ``mixed``: ``num_hard`` hard then ``num_random`` uniform;
* ``mined``: ``min(num_hard, M)`` columns of the user's mined pool (an
  ``[n_users, M]`` table from :func:`mine_hard_negatives`) drawn per
  step, then ``num_random`` uniform ids; seen items are not filtered.

:func:`mine_hard_negatives` ranks each user's unseen items by the
model's retrieval logit on the port's devices (``torch`` is imported
inside it).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


class NegativeSampler:
    def __init__(
        self,
        strategy: str = "random",
        num_hard: int = 5,
        num_random: int = 10,
        seed: int = 42,
    ):
        if strategy not in ("random", "hard", "mixed", "mined"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.num_hard = num_hard
        self.num_random = num_random
        self.rng = np.random.default_rng(seed)
        self.item_popularity: Optional[np.ndarray] = None
        self.user_seen: Dict[int, np.ndarray] = {}
        self.n_items = 0

    def fit(self, user_ids: np.ndarray, item_ids: np.ndarray, n_items: int) -> "NegativeSampler":
        """Item popularity and per-user seen sets from the train
        interactions (dense int ids)."""
        self.n_items = n_items
        self.item_popularity = np.bincount(item_ids, minlength=n_items).astype(np.int64)
        order = np.argsort(user_ids, kind="stable")
        u_sorted, i_sorted = user_ids[order], item_ids[order]
        bounds = np.searchsorted(u_sorted, np.arange(u_sorted.max() + 2))
        for u in np.unique(u_sorted):
            self.user_seen[int(u)] = np.unique(i_sorted[bounds[u]:bounds[u + 1]])
        self._pop_order = np.argsort(-self.item_popularity, kind="stable")
        return self

    def set_mined(self, table: np.ndarray) -> "NegativeSampler":
        """Install the mined per-user table ([n_users, M] dense item ids
        from :func:`mine_hard_negatives`) for ``strategy="mined"``."""
        self.mined_table = np.asarray(table, np.int32)
        return self

    def n_negatives(self) -> int:
        if self.strategy == "random":
            return self.num_random
        if self.strategy == "hard":
            return self.num_hard
        return self.num_hard + self.num_random

    def sample_negatives(self, user_id: int) -> np.ndarray:
        """Fixed-length negatives of one user, seen items filtered (with a
        uniform fallback when the unseen pool is small)."""
        if self.item_popularity is None:
            raise ValueError("call fit() first")
        seen = self.user_seen.get(int(user_id), np.empty(0, np.int64))
        k = self.n_negatives()
        out = np.empty(0, np.int64)
        if self.strategy in ("hard", "mixed"):
            hard_pool = self._pop_order[~np.isin(self._pop_order, seen)][:max(self.num_hard * 4, 32)]
            n_h = self.num_hard if self.strategy == "mixed" else k
            out = hard_pool[:n_h]
        if self.strategy in ("random", "mixed"):
            n_r = self.num_random if self.strategy == "mixed" else k
            cand = self.rng.integers(0, self.n_items, n_r * 3)
            cand = cand[~np.isin(cand, seen) & ~np.isin(cand, out)][:n_r]
            while len(cand) < n_r:  # a tiny catalog
                cand = np.concatenate([cand, self.rng.integers(0, self.n_items, n_r)])[:n_r]
            out = np.concatenate([out, cand])
        if len(out) < k:
            out = np.concatenate([out, self.rng.integers(0, self.n_items, k - len(out))])
        return out[:k].astype(np.int32)

    def sample_batch(self, user_ids: np.ndarray) -> np.ndarray:
        """[B] -> [B, n_negatives] int32. Hard negatives come from a
        per-user cache built on first use; random negatives are uniform
        draws without a seen filter (an accidental positive is rare in a
        sparse log and standard in sampled softmax)."""
        b = len(user_ids)
        parts = []
        if self.strategy == "mined":
            # a per-step subset of each user's mined pool, then a uniform tail
            table = self.mined_table
            m = table.shape[1]
            n_h = min(self.num_hard, m)
            cols = self.rng.integers(0, m, (b, n_h))
            parts.append(np.take_along_axis(table[user_ids], cols, axis=1).astype(np.int32))
            parts.append(self.rng.integers(0, self.n_items, (b, self.num_random))
                         .astype(np.int32))
            return np.concatenate(parts, axis=1)
        if self.strategy in ("hard", "mixed"):
            n_h = self.num_hard if self.strategy == "mixed" else self.n_negatives()
            if not hasattr(self, "_hard_cache"):
                self._build_hard_cache()
            parts.append(self._hard_cache[user_ids][:, :n_h])
        if self.strategy in ("random", "mixed"):
            n_r = self.num_random if self.strategy == "mixed" else self.n_negatives()
            parts.append(self.rng.integers(0, self.n_items, (b, n_r)).astype(np.int32))
        return np.concatenate(parts, axis=1)

    def _build_hard_cache(self) -> None:
        """Per-user most-popular unseen items, one pass over the users."""
        n_h = max(self.num_hard, 1)
        max_u = max(self.user_seen.keys(), default=0)
        cache = np.tile(self._pop_order[:n_h].astype(np.int32), (max_u + 1, 1))
        head = self._pop_order[:n_h * 8]
        for u, seen in self.user_seen.items():
            pool = head[~np.isin(head, seen)][:n_h]
            if len(pool) == n_h:
                cache[u] = pool
        self._hard_cache = cache


def mine_hard_negatives(
    tower_params,
    model_cfg,
    bundle: Dict[str, np.ndarray],
    m: int = 50,
    batch: int = 1024,
    skip_top: int = 0,
    device="cuda",
) -> np.ndarray:
    """Per-user true hard negatives from a trained index: ranks
    ``[skip_top, skip_top + m)`` of each user's unseen items by the
    model's retrieval logit (dot product plus the learned item bias, what
    serving retrieves), in chunks of ``batch`` users on ``device``.

    ``skip_top`` skips the index's head, where a user's held-out future
    items rank: mining them would turn future positives into negatives.
    A catalog smaller than ``skip_top + m`` clamps the window, with a
    warning, to the widest non-empty one that fits.

    ``tower_params``: the two-tower tree, of numpy arrays (e.g.
    ``load_encoder_params``) or tensors. -> ``[n_users, m]`` int32 dense
    item ids, for ``NegativeSampler.set_mined``."""
    import torch

    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.retrieval.evaluator import SeenIndex, _topk_batch_masked
    from recsys_tpu_torch.retrieval.scorer import materialize_item_embeddings
    from recsys_tpu_torch.train.checkpoint import params_from_numpy
    from recsys_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return node.detach().to(dev, torch.float32)
        return params_from_numpy(node, dev)

    tower_params = place(tower_params)
    n_users = int(bundle["meta/n_users"])
    n_items = int(bundle["meta/n_movies"])
    seen = SeenIndex(bundle["train/user_id"], bundle["train/movie_id"], n_users, n_items)
    eff_skip = max(0, min(skip_top, n_items - m))
    k_mine = min(eff_skip + m, n_items)
    if eff_skip != skip_top or k_mine - eff_skip != m:
        logger.warning("mine_hard_negatives: catalog of %d items clamps the requested "
                       "ranks [%d, %d) to [%d, %d)",
                       n_items, skip_top, skip_top + m, eff_skip, k_mine)
    out = np.empty((n_users, k_mine - eff_skip), np.int32)
    with torch.inference_mode():
        item_embs = materialize_item_embeddings(tower_params, model_cfg, n_items)
        bias = tower_params["item_bias"][:n_items]
        for lo in range(0, n_users, batch):
            chunk = np.arange(lo, min(lo + batch, n_users), dtype=np.int32)
            u_emb = TwoTower.user_embed(tower_params, torch.from_numpy(chunk).to(dev),
                                        model_cfg)
            mask = torch.from_numpy(seen.batch_mask(chunk)).to(dev)
            _, top = _topk_batch_masked(u_emb, item_embs, mask, k_mine, normalize=False,
                                        item_bias=bias)
            out[chunk] = top[:, eff_skip:].cpu().numpy()
    return out
