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
  ``backend="exported"`` retrieves through the ``torch.export`` artifact
  of ``serve/export.py`` instead (user tower, normalize, matmul,
  ``torch.topk`` in one program), refused when the bundle changed since
  the export. A model with engineered dense features reranks with the
  bundle's fitted ``FeatureEngineer`` (``features.npz``), its features
  computed on the host at the end-of-train timestamp and sent to the
  device.
* :class:`StubRecommendationService` is the model-free degraded-mode
  stand-in with seeded random embeddings.

Contract notes, as in the JAX package: ``recommend`` scores are cosine,
``score`` is the raw dot product, and an unknown user gets the
popularity fallback (first-k catalog order, scores ``1 - 0.05*i``).

The device and exported backends are ported. ``"auto"`` means the device
backend (the JAX package's "auto" picks its host backend).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.serve.export import DEFAULT_ARTIFACT, bundle_fingerprint, load_exported
from recsys_tpu_torch.train.checkpoint import (
    load_encoder_params, load_feature_engineer, load_model_params, params_from_numpy,
)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# backends of the JAX package that the port does not have yet, and the
# ROADMAP Queue 1 item that will bring each
NOT_PORTED_BACKENDS = {
    "native": "item 4, the rest of serving",
    "sharded": "item 8, multi-GPU",
}
BACKENDS = ("auto", "device", "native", "sharded", "exported")


# what get_model_info reports for each top-k route
_SEARCH_ROUTES = {
    "int8": "int8 catalog, blockwise top-4k, exact fp32 refine",
    "approx": "group-max sieve over the bf16 catalog (blockmax)",
    "exact": "exact top-k (flash top-k for k <= 256)",
    "exported": "exported artifact (torch.export: tower, matmul, torch.topk)",
}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RecommendationService:
    """``backend``: ``"device"`` or ``"auto"`` (the same thing here), or
    ``"exported"``: retrieval through the artifact at ``exported_path``
    (default ``<model_dir>/retrieve.pt2``), loaded onto ``device``.
    ``device``: ``"cuda"`` (default; raises if absent) or ``"cpu"``."""

    def __init__(self, model_dir: str, backend: str = "auto",
                 approx_search_threshold: int = 1_000_000,
                 rerank_candidates: int = 0,
                 rerank_ctr_weight: float = 0.25,
                 rerank_rating_weight: float = 0.0,
                 int8_catalog: bool = False,
                 device: DeviceLike = "cuda",
                 exported_path: Optional[str] = None):
        if backend in NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to recsys_tpu_torch yet "
                f"(ROADMAP Queue 1: {NOT_PORTED_BACKENDS[backend]})")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.exported_path = exported_path
        self._exported_fn = None
        self._exported_k = 0
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
        self.feature_engineer = None
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
            params = load_model_params(d)
            # the fitted FeatureEngineer (present when the model takes
            # engineered dense features): rerank computes the training-time
            # features, with "now" the end of train
            self.feature_engineer = load_feature_engineer(d)
            if params is None:
                logger.warning("rerank requested but %s has no model.npz; "
                               "serving retrieval-only", d)
            elif self.config.model.dense_features > 0 and self.feature_engineer is None:
                logger.warning("model consumes dense features but %s has no "
                               "features.npz; serving retrieval-only", d)
            else:
                self.model_params = params_from_numpy(params, self.device)
        self.index = RetrievalIndex.load(os.path.join(d, "index.npz"), self.device)
        if self.backend == "exported":
            self._load_exported()
        self._popular = [int(r) for r in self.index.item_raw_ids[:200]]
        self._ready = True
        logger.info("loaded model from %s (%d users, %d items) on %s",
                    d, len(self.user_id_map), len(self.item_id_map), self.device)
        return self

    def _load_exported(self) -> None:
        """The artifact and its metadata; refuses an artifact built from
        another bundle (its weights and catalog order would not be this
        bundle's, while ids map through this bundle's index) and a rerank
        deeper than the exported k."""
        d = self.model_dir
        path = self.exported_path or os.path.join(d, DEFAULT_ARTIFACT)
        with open(path + ".json") as f:
            meta = json.load(f)
        current = bundle_fingerprint(d)
        stamped = meta.get("source_fingerprint")
        if stamped != current:
            raise ValueError(
                f"exported artifact {path} was built from a different bundle than "
                f"{d} (stamped fingerprint {stamped!r}, current {current[:16]}...): "
                "the bundle was retrained or rebuilt after export; re-run "
                "python -m recsys_tpu_torch.export")
        self._exported_k = int(meta["k"])
        if self.rerank_candidates > self._exported_k:
            raise ValueError(
                f"rerank_candidates={self.rerank_candidates} exceeds the artifact's "
                f"exported top-k ({self._exported_k}); re-export with a larger --k")
        self._exported_fn = load_exported(path, self.device)

    def is_ready(self) -> bool:
        return self._ready

    # ---- core ops --------------------------------------------------
    @torch.inference_mode()
    def _user_embedding(self, dense_uid):
        ids = torch.as_tensor(np.atleast_1d(np.asarray(dense_uid)), device=self.device)
        return TwoTower.user_embed(self.encoder_params, ids, self.config.model)

    def _search_route(self) -> str:
        if self.backend == "exported":
            return "exported"
        if self.int8_catalog:
            return "int8"
        n_index_rows = self.index.item_embeddings_np.shape[0]
        if self.approx_search_threshold and n_index_rows > self.approx_search_threshold:
            return "approx"
        return "exact"

    def _retrieve(self, dense_ids, k: int):
        """dense user ids -> (cosine scores [Q, k], catalog rows [Q, k])."""
        route = self._search_route()
        if route == "exported":
            if k > self._exported_k:
                raise ValueError(f"k={k} exceeds the artifact's exported top-k "
                                 f"({self._exported_k}); re-export with a larger --k")
            scores, idx = self._exported_fn(np.atleast_1d(np.asarray(dense_ids)))
            return scores[:, :k], idx[:, :k]
        u = self._user_embedding(dense_ids)
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
        full per-pair ``MultiTaskModel.apply`` on the device; with dense
        features, each pair's engineered features at the end-of-train
        timestamp, computed on the host."""
        idx = np.asarray(idx)
        q, c = idx.shape
        users = np.repeat(np.asarray(dense_uids), c)
        flat_u = torch.as_tensor(users, device=self.device)
        flat_i = torch.as_tensor(idx.reshape(-1), device=self.device)
        dense = None
        if self.config.model.dense_features > 0:
            eng = self.feature_engineer
            feats = eng.transform_scaled(users, idx.reshape(-1),
                                         np.full(len(users), eng.t_ref))
            dense = torch.as_tensor(feats, device=self.device)
        out = MultiTaskModel.apply(self.model_params, self.config.model, flat_u, flat_i,
                                   dense=dense)
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
            "backend": (f"recsys_tpu_torch "
                        f"{'exported' if self.backend == 'exported' else 'device'} "
                        f"scorer ({self.device.type})"),
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
