"""Recommendation services (the counterpart of
``recsys_tpu/serve/service.py``).

* :class:`RecommendationService` loads the inference bundle
  (``encoder.npz`` + ``vocabs.json`` + ``config.json`` + ``index.npz``,
  and ``model.npz`` for two-stage rerank) and serves top-k on one device:
  the user tower, then top-k over the catalog, then optionally the DCN
  rerank of the candidates (the fused cross-stack kernel on the card).
  The top-k route, as in the JAX package's device backend: the int8
  catalog with an exact fp32 refine under ``int8_catalog``; else, above
  ``approx_search_threshold`` items, the group-max sieve (the blockmax
  kernel on the card); else exact top-k (the flash top-k kernel).
* :class:`StubRecommendationService` is the model-free degraded-mode
  stand-in with seeded random embeddings.

Contract notes, as in the JAX package: ``recommend`` scores are cosine,
``score`` is the raw dot product, and an unknown user gets the
popularity fallback (first-k catalog order, scores ``1 - 0.05*i``).

Only the device backend is ported. ``"auto"`` means that backend on the
card (the JAX package's "auto" picks its host backend).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train.checkpoint import (
    load_encoder_params, load_model_params, params_from_numpy,
)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# backends of the JAX package that the port does not have yet, and the
# ROADMAP item that will bring each
_NOT_PORTED_BACKENDS = {
    "native": "host serving backends",
    "sharded": "multi-GPU",
    "exported": "export",
}


# what get_model_info reports for each top-k route
_SEARCH_ROUTES = {
    "int8": "int8 catalog, blockwise top-4k, exact fp32 refine",
    "approx": "group-max sieve over the bf16 catalog (blockmax)",
    "exact": "exact top-k (flash top-k for k <= 256)",
}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RecommendationService:
    """``backend``: ``"device"`` or ``"auto"`` (the same thing here).
    ``device``: ``"cuda"`` (default; raises if absent) or ``"cpu"``."""

    def __init__(self, model_dir: str, backend: str = "auto",
                 approx_search_threshold: int = 1_000_000,
                 rerank_candidates: int = 0,
                 rerank_ctr_weight: float = 0.25,
                 rerank_rating_weight: float = 0.0,
                 int8_catalog: bool = False,
                 device: DeviceLike = "cuda"):
        if backend in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to recsys_tpu_torch yet "
                f"(ROADMAP Queue 1: {_NOT_PORTED_BACKENDS[backend]})")
        if backend not in ("auto", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)
        # int8-quantized catalog (4x less device memory), searched
        # blockwise, its top 4k candidates rescored exactly in fp32
        self.int8_catalog = int8_catalog
        # catalogs larger than this take the group-max sieve over the bf16
        # catalog (the JAX package's approx_max_k route); 0 = never
        self.approx_search_threshold = approx_search_threshold
        # two-stage serving: retrieve this many candidates, rerank by
        # retrieval score + ctr weight * CTR logit (+ rating weight *
        # rating prediction); 0 = retrieval only. Needs model.npz.
        self.rerank_candidates = rerank_candidates
        self.rerank_ctr_weight = rerank_ctr_weight
        self.rerank_rating_weight = rerank_rating_weight
        self.model_dir = model_dir
        self.config: RecsysConfig = None
        self.encoder_params = None
        self.model_params = None
        self.index: RetrievalIndex = None
        self.user_id_map: Dict[int, int] = {}
        self.item_id_map: Dict[int, int] = {}
        self._popular: List[int] = []
        self._ready = False
        self.model_version = "1.0.0"

    # ---- lifecycle -------------------------------------------------
    def load(self) -> "RecommendationService":
        d = self.model_dir
        self.config = RecsysConfig.load(os.path.join(d, "config.json"))
        with open(os.path.join(d, "vocabs.json")) as f:
            vocabs = json.load(f)
        self.user_id_map = {int(u): i for i, u in enumerate(vocabs["users"])}
        self.item_id_map = {int(m): i for i, m in enumerate(vocabs["items"])}
        self.encoder_params = params_from_numpy(load_encoder_params(d), self.device)
        if self.rerank_candidates > 0:
            if self.config.model.dense_features > 0:
                raise NotImplementedError(
                    "rerank of a model with dense_features > 0 needs the "
                    "feature engineer, which is not ported to "
                    "recsys_tpu_torch yet (ROADMAP Queue 1: data and features)")
            params = load_model_params(d)
            if params is None:
                logger.warning("rerank requested but %s has no model.npz; "
                               "serving retrieval-only", d)
            else:
                self.model_params = params_from_numpy(params, self.device)
        self.index = RetrievalIndex.load(os.path.join(d, "index.npz"), self.device)
        self._popular = [int(r) for r in self.index.item_raw_ids[:200]]
        self._ready = True
        logger.info("loaded model from %s (%d users, %d items) on %s",
                    d, len(self.user_id_map), len(self.item_id_map), self.device)
        return self

    def is_ready(self) -> bool:
        return self._ready

    # ---- core ops --------------------------------------------------
    @torch.inference_mode()
    def _user_embedding(self, dense_uid):
        ids = torch.as_tensor(np.atleast_1d(np.asarray(dense_uid)), device=self.device)
        return TwoTower.user_embed(self.encoder_params, ids, self.config.model)

    def _search_route(self) -> str:
        if self.int8_catalog:
            return "int8"
        n_index_rows = self.index.item_embeddings_np.shape[0]
        if self.approx_search_threshold and n_index_rows > self.approx_search_threshold:
            return "approx"
        return "exact"

    def _retrieve(self, dense_ids, k: int):
        """dense user ids -> (cosine scores [Q, k], catalog rows [Q, k])."""
        u = self._user_embedding(dense_ids)
        route = self._search_route()
        if route == "int8":
            return self.index.search(u, k, int8=True, approx=True, refine_factor=4)
        if route == "approx":
            return self.index.search(u, k, approx=True)
        return self.index.search(u, k)

    def _rerank_active(self) -> bool:
        return self.rerank_candidates > 0 and self.model_params is not None

    @torch.inference_mode()
    def _rerank(self, dense_uids, scores, idx, k: int):
        """Two-stage rerank: [Q, C] candidates -> top-[Q, k] by retrieval
        score + ctr weight * CTR logit [+ rating weight * rating], from a
        full per-pair ``MultiTaskModel.apply`` on the device."""
        idx = np.asarray(idx)
        q, c = idx.shape
        flat_u = torch.as_tensor(np.repeat(np.asarray(dense_uids), c), device=self.device)
        flat_i = torch.as_tensor(idx.reshape(-1), device=self.device)
        out = MultiTaskModel.apply(self.model_params, self.config.model, flat_u, flat_i)
        ctr = out.ctr_logit.cpu().numpy().reshape(q, c)
        combined = np.asarray(scores) + self.rerank_ctr_weight * ctr
        if self.rerank_rating_weight:
            rating = out.rating_pred.cpu().numpy().reshape(q, c)
            combined = combined + self.rerank_rating_weight * rating
        order = np.argsort(-combined, axis=1)[:, :k]
        return (np.take_along_axis(combined, order, axis=1),
                np.take_along_axis(idx, order, axis=1))

    def _ranked(self, dense_ids, k: int):
        if self._rerank_active():
            c = max(self.rerank_candidates, k)
            scores, ids = self._retrieve(dense_ids, c)
            return self._rerank(dense_ids, scores, ids, k)
        return self._retrieve(dense_ids, k)

    def _items(self, ids_row, scores_row) -> List[Dict]:
        return [
            {"item_id": int(self.index.item_raw_ids[i]), "score": float(s),
             "rank": r + 1}
            for r, (i, s) in enumerate(zip(ids_row, scores_row))
        ]

    def recommend(self, user_id: int, k: int = 10) -> List[Dict]:
        """Top-k for one user; cosine scores; popularity fallback for
        unknown users."""
        if not self._ready:
            raise RuntimeError("service not loaded")
        dense = self.user_id_map.get(int(user_id))
        if dense is None:
            return self._popular_items(k)
        scores, ids = self._ranked([dense], k)
        return self._items(ids[0], scores[0])

    def recommend_batch(self, user_ids: List[int], k: int = 10) -> List[Dict]:
        """Batch variant: one user-tower call and one top-k call for all
        known users."""
        if not self._ready:
            raise RuntimeError("service not loaded")
        dense = [self.user_id_map.get(int(u)) for u in user_ids]
        known = [i for i, d in enumerate(dense) if d is not None]
        out: List[Dict] = [
            {"user_id": int(u), "recommendations": self._popular_items(k),
             "status": "cold_start"}
            for u in user_ids
        ]
        if known:
            scores, top = self._ranked(np.array([dense[i] for i in known]), k)
            for row, i in enumerate(known):
                out[i] = {
                    "user_id": int(user_ids[i]),
                    "recommendations": self._items(top[row], scores[row]),
                    "status": "ok",
                }
        return out

    def score(self, user_id: int, item_ids: List[int],
              normalized: bool = False) -> List[Dict]:
        """Score given items for a user: raw dot by default,
        ``normalized=True`` gives cosine."""
        if not self._ready:
            raise RuntimeError("service not loaded")
        dense_u = self.user_id_map.get(int(user_id))
        if dense_u is None:
            raise ValueError(f"unknown user_id {user_id}")
        dense_items = []
        for m in item_ids:
            d = self.item_id_map.get(int(m))
            if d is None:
                raise ValueError(f"unknown item_id {m}")
            dense_items.append(d)
        u = _host(self._user_embedding(dense_u))
        sel = self.index.item_embeddings_np[np.array(dense_items)]
        if normalized:
            u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
            sel = sel / np.maximum(np.linalg.norm(sel, axis=-1, keepdims=True), 1e-12)
        s = (u @ sel.T)[0]
        return [{"item_id": int(m), "score": float(v)} for m, v in zip(item_ids, s)]

    def _popular_items(self, k: int) -> List[Dict]:
        """Cold-start fallback, fabricated scores 1 - 0.05*i."""
        return [
            {"item_id": int(m), "score": round(1.0 - 0.05 * i, 4), "rank": i + 1}
            for i, m in enumerate(self._popular[:k])
        ]

    def get_model_info(self) -> Dict:
        enc = os.path.join(self.model_dir, "encoder.npz")
        mtime = os.path.getmtime(enc) if os.path.exists(enc) else None
        return {
            "model_version": self.model_version,
            "model_dir": self.model_dir,
            "bundle_mtime": mtime,
            "n_users": len(self.user_id_map),
            "n_items": len(self.item_id_map),
            "embedding_dim": self.config.model.embedding_dim if self.config else None,
            "backend": f"recsys_tpu_torch device scorer ({self.device.type})",
            "search": (_SEARCH_ROUTES[self._search_route()]
                       if self.index is not None else None),
            "ready": self._ready,
        }


class StubRecommendationService(RecommendationService):
    """Degraded-mode stand-in: no trained artifacts needed; seeded random
    embeddings. Exercises the API without a bundle."""

    def __init__(self, n_users: int = 100, n_items: int = 200, dim: int = 16,
                 seed: int = 42, device: DeviceLike = "cuda"):
        super().__init__(model_dir="<stub>", device=device)
        rng = np.random.default_rng(seed)
        self.config = RecsysConfig(model=ModelConfig(embedding_dim=dim))
        self.user_id_map = {i + 1: i for i in range(n_users)}
        self.item_id_map = {i + 1: i for i in range(n_items)}
        self._stub_user_embs = rng.normal(size=(n_users, dim)).astype(np.float32)
        self.index = RetrievalIndex(
            rng.normal(size=(n_items, dim)).astype(np.float32),
            np.arange(1, n_items + 1), device=self.device,
        )
        self._popular = [int(r) for r in self.index.item_raw_ids[:200]]
        self._ready = True
        self.model_version = "stub-0.0.0"

    def _user_embedding(self, dense_uid) -> np.ndarray:
        return self._stub_user_embs[np.atleast_1d(np.asarray(dense_uid))]
