"""Recommendation services (the counterpart of
``recsys_tpu/serve/service.py``).

* :class:`RecommendationService` loads the inference bundle
  (``encoder.npz`` + ``vocabs.json`` + ``config.json`` + ``index.npz``,
  and ``model.npz`` for two-stage rerank) and serves top-k: the user
  tower, then top-k over the catalog, then optionally the DCN rerank of
  the candidates. Its backends:

  - ``"device"`` (and ``"auto"``, the same thing here: the JAX package's
    "auto" picks its host backend when the C++ library loads) runs on
    one device. The top-k route, as in the JAX package's device backend:
    the int8 catalog with an exact fp32 refine under ``int8_catalog``;
    else, above ``approx_search_threshold`` items, the group-max sieve
    (the blockmax kernel on the card); else exact top-k (the flash top-k
    kernel). The rerank is a per-pair ``MultiTaskModel.apply`` on the
    device (the fused cross-stack kernel on the card); ``_FastRerank``
    is never built for it.
  - ``"native"`` is the caller asking for the host: the numpy user tower,
    one BLAS product over the normalised catalog kept on the host, then
    ``argpartition`` (``int8_catalog`` is ignored, as in the JAX
    package), and the rerank in fp32 numpy. It touches no CUDA state and
    loads on a machine without a card, whatever ``device`` says.
  - ``"exported"`` retrieves through the ``torch.export`` artifact of
    ``serve/export.py`` (user tower, normalize, matmul, ``torch.topk`` in
    one program), refused when the bundle changed since the export.
  - ``"sharded"`` searches the catalog row-sharded over the ``model``
    axis of a mesh (:class:`~recsys_tpu_torch.retrieval.scorer.ShardedIndex`,
    int8 shards under ``int8_catalog``): each rank's exact top-k of its
    shard, merged across ranks, at every catalog size (never the sieve).
    The mesh defaults to every rank of the process group on the ``model``
    axis: one rank, one card without a launcher. Every rank loads the
    service and takes part in each search, in the same order. The rerank
    runs as on the device backend (the fused cross-stack kernel on the
    card), where the JAX package's sharded backend reranks on the host
    through its ``_FastRerank``: under mixed precision the two reranks
    agree to the bf16 rounding of the device's operands.

  ``"native"`` and ``"exported"`` rerank on the host through
  :class:`_FastRerank`, built at load and self-checked against the exact
  per-pair host path; where the check fails the exact host path serves
  under ``"native"`` and the device rerank under ``"exported"``, as in
  the JAX package. A model with engineered dense features reranks with
  the bundle's fitted ``FeatureEngineer`` (``features.npz``) at the
  end-of-train timestamp; ``_FastRerank`` needs it only at build.
* :class:`StubRecommendationService` is the model-free degraded-mode
  stand-in with seeded random embeddings.

Contract notes, as in the JAX package: ``recommend`` scores are cosine,
``score`` is the raw dot product, and an unknown user gets the
popularity fallback (first-k catalog order, scores ``1 - 0.05*i``).
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
from recsys_tpu_torch.parallel.mesh import make_mesh, rank_device, world_size
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, ShardedIndex
from recsys_tpu_torch.serve import BACKENDS
from recsys_tpu_torch.serve.export import DEFAULT_ARTIFACT, bundle_fingerprint, load_exported
from recsys_tpu_torch.train.checkpoint import (
    load_encoder_params, load_feature_engineer, load_model_params, params_from_numpy,
    params_to_numpy,
)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# backends whose rerank runs on the host through _FastRerank
HOST_RERANK_BACKENDS = ("native", "exported")

# what get_model_info reports for each top-k route
_SEARCH_ROUTES = {
    "int8": "int8 catalog, blockwise top-4k, exact fp32 refine",
    "approx": "group-max sieve over the bf16 catalog (blockmax)",
    "exact": "exact top-k (flash top-k for k <= 256)",
    "exported": "exported artifact (torch.export: tower, matmul, torch.topk)",
    "native": "host: BLAS product over the normalised catalog, argpartition",
    "sharded": "catalog row-sharded over the mesh's model axis: each shard's exact "
               "top-k (int8 shards under int8_catalog), merged across ranks",
}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _l2_normalize_np(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class _FastRerank:
    """Precomputed host rerank: the DCN heads for [Q, C] candidate sets
    in gathers and a few small products instead of a per-pair model
    forward (the counterpart of the JAX package's ``_FastRerank``).

    Three observations make the collapse exact:

    1. **Towers are per-entity**: the user and item tower outputs depend
       only on the id, so the whole catalog's and user vocabulary's are
       computed once at build.
    2. **The rank-1 cross stack is separable**: with
       ``x_{l+1} = x0 (x_l . w_l) + b_l + x_l`` and per-row input x0,
       induction gives ``x_l = x0 * alpha_l + beta_l`` with a per-row
       scalar alpha (``alpha_{l+1} = alpha_l (x0.w_l + 1) + beta_l.w_l``)
       and a constant vector beta (``beta_{l+1} = beta_l + b_l``). Every
       ``x0 . w`` splits into user, item and feature blocks, each a
       per-entity dot computed once, so the cross stack and its slice of
       each head cost a few [Q*C] vector operations.
    3. **Engineered features are additive-separable** but for two
       pairwise columns (``PAIR_COLS``): at the fixed serving timestamp
       (``t_ref``) every other column is user-only, item-only or
       constant, so ``f(u, i) = FU[u] + FI[i] - f0`` column by column.
       The split is probed empirically at build (one transform sweep per
       entity axis), and the whole is checked against the exact path on
       64 random pairs, both heads, before it serves: :meth:`build`
       returns None on a mismatch, and the exact path serves.

    What is left per request: the pairwise columns' strips ([Q*C, 2] x
    [2, H]) and the deep MLP past its first layer, whose user and item
    partials are computed once too. Numpy in fp32 throughout.
    """

    PAIR_COLS = ("log_pop_match", "user_genre_match")

    def __init__(self):
        self.ok = False

    # ---- build -------------------------------------------------------
    @classmethod
    def build(cls, params, cfg, engineer, n_users: int, n_items: int,
              tower_np, exact_fn) -> Optional["_FastRerank"]:
        """``params``: the model's numpy tree; ``tower_np(params, table,
        tower, ids)``: the numpy tower; ``exact_fn(flat_u, flat_i)``: the
        exact per-pair [N, 2] (ctr, rating), or [N] / [N, 1] ctr only."""
        self = cls()
        try:
            self._precompute(params, cfg, engineer, n_users, n_items, tower_np)
        except Exception:  # a boundary that must keep serving: the exact path does
            logger.exception("fast-rerank precompute failed; serving the exact per-pair path")
            return None
        rng = np.random.default_rng(0)
        q = min(64, n_users)
        uids = rng.integers(0, n_users, q)
        cands = rng.integers(0, n_items, (q, 3))
        fast = np.stack(self.logits(uids, cands), axis=-1)  # [q, 3, 2]
        exact = np.asarray(exact_fn(np.repeat(uids, 3), cands.reshape(-1))).reshape(q, 3, -1)
        if exact.shape[-1] == 1:  # a ctr-only exact function
            fast = fast[..., :1]
        if not np.allclose(fast, exact, rtol=1e-3, atol=1e-4):
            logger.warning(
                "fast-rerank self-check failed (max |diff| %.3g): a feature column is "
                "not user/item-separable or the DCN shape changed; serving the exact "
                "per-pair path", float(np.max(np.abs(fast - exact))))
            return None
        self.ok = True
        return self

    def _precompute(self, params, cfg, engineer, n_users, n_items, tower_np) -> None:
        D = cfg.embedding_dim
        tw = params["towers"]
        all_items = np.arange(n_items)
        all_users = np.arange(n_users)
        V = tower_np(tw, "item_table", "item_tower", all_items)
        UT = tower_np(tw, "user_table", "user_tower", all_users)

        # ---- feature separation (empirical probe) --------------------
        self.n_feat = 0
        self.pair_idx: List[int] = []
        FU0 = FI0 = f00 = None
        if cfg.dense_features > 0:
            eng = engineer
            t = np.full(max(n_users, n_items), eng.t_ref)
            names = eng.feature_names()
            self.n_feat = len(names)
            FU = eng.transform_scaled(all_users, np.zeros(n_users, np.int64), t[:n_users])
            FI = eng.transform_scaled(np.zeros(n_items, np.int64), all_items, t[:n_items])
            f0 = eng.transform_scaled(np.zeros(1, np.int64), np.zeros(1, np.int64),
                                      np.full(1, eng.t_ref))[0]
            self.pair_idx = [names.index(c) for c in self.PAIR_COLS if c in names]
            FU0, FI0, f00 = FU.copy(), FI.copy(), f0.copy()
            for j in self.pair_idx:
                FU0[:, j] = 0.0
                FI0[:, j] = 0.0
                f00[j] = 0.0
            # the pairwise columns' raw ingredients and their scaling
            self.lu = np.log1p(np.asarray(eng.u_cnt, np.float64))
            self.li = np.log1p(np.asarray(eng.i_cnt, np.float64))
            self.genre_prefs = eng.user_genre_prefs
            self.item_genres = eng.item_genres
            if eng.standardize and hasattr(eng, "scaler"):
                self.pair_mean = np.array([eng.scaler.mean_[j] for j in self.pair_idx])
                self.pair_scale = np.array([eng.scaler.scale_[j] for j in self.pair_idx])
            else:
                self.pair_mean = np.zeros(len(self.pair_idx))
                self.pair_scale = np.ones(len(self.pair_idx))
            self.clip_std = getattr(eng, "clip_std", 0.0)
            self.pair_names = [names[j] for j in self.pair_idx]
        F_in = 2 * D + self.n_feat

        def entity_dots(w):
            """Per-entity dots of x0's blocks with a weight [F_in] or
            [F_in, H] -> (user part [n_users, ...], item part [n_items,
            ...], constant part, the pairwise columns' rows)."""
            w = np.asarray(w, np.float32)
            wu, wv, wf = w[:D], w[D:2 * D], w[2 * D:]
            u_part = UT @ wu
            i_part = V @ wv
            c_part = 0.0
            pair_rows = None
            if self.n_feat:
                u_part = u_part + FU0 @ wf
                i_part = i_part + FI0 @ wf
                c_part = -(f00 @ wf)
                pair_rows = wf[self.pair_idx]
            return u_part, i_part, c_part, pair_rows

        # ---- cross stack ---------------------------------------------
        dcn = params["dcn"]
        self.cross = []
        beta = np.zeros(F_in, np.float32)
        for i in range(cfg.cross_layers):
            layer = dcn["cross"][f"layer_{i}"]
            w = np.asarray(layer["w"], np.float32)
            self.cross.append({"dots": entity_dots(w), "beta_dot_w": float(beta @ w)})
            beta = beta + np.asarray(layer["b"], np.float32)
        self.beta_L = beta

        # ---- heads: the cross slice separable, the deep slice direct --
        # both heads read the same trunk feature, so the rating head costs
        # a second set of per-entity dots on the same alpha and deep trunk
        def head_pre(name: str) -> dict:
            w = np.asarray(params[name]["w"], np.float32)[:, 0]
            return {
                "b": float(np.asarray(params[name]["b"])[0]),
                "cross_dots": entity_dots(w[:F_in]),
                "beta_dot": float(beta @ w[:F_in]),
                "deep": w[F_in:],
            }

        self.heads = (head_pre("ctr_head"), head_pre("rating_head"))

        # ---- deep MLP: the first layer computed per entity -------------
        deep = dcn["deep"]
        self.deep_rest: List[tuple] = []
        self.Q1 = self.P1 = None
        if deep:
            w1 = np.asarray(deep["layer_0"]["w"], np.float32)
            b1 = np.asarray(deep["layer_0"]["b"], np.float32)
            u1, i1, c1, pair1 = entity_dots(w1)
            self.Q1, self.P1 = u1, i1
            self.c1 = b1 + c1
            self.pair1 = pair1
            for i in range(1, len(deep)):
                layer = deep[f"layer_{i}"]
                self.deep_rest.append((np.asarray(layer["w"], np.float32),
                                       np.asarray(layer["b"], np.float32)))

    # ---- per request ---------------------------------------------------
    def _pair_cols(self, urep: np.ndarray, flat: np.ndarray) -> np.ndarray:
        """[Q*C, P] scaled and clipped pairwise feature columns."""
        cols = []
        for name in self.pair_names:
            if name == "log_pop_match":
                cols.append(np.abs(self.lu[urep] - self.li[flat]))
            else:  # user_genre_match
                cols.append(np.einsum("ng,ng->n", self.genre_prefs[urep],
                                      self.item_genres[flat]))
        p = np.stack(cols, axis=1).astype(np.float64)
        p = (p - self.pair_mean) / self.pair_scale
        if self.clip_std:
            p = np.clip(p, -self.clip_std, self.clip_std)
        return p.astype(np.float32)

    def logits(self, uids: np.ndarray, cands: np.ndarray, need_rating: bool = True) -> tuple:
        """uids [Q], cands [Q, C] -> (ctr logits, rating predictions), each
        [Q, C], from one shared trunk pass; the rating head is skipped
        (None) when ``need_rating`` is False."""
        q, c = cands.shape
        flat = cands.reshape(-1)
        urep = np.repeat(np.asarray(uids), c)
        pair = self._pair_cols(urep, flat) if self.pair_idx else None

        def dot_x0(dots):
            u_part, i_part, c_part, pair_rows = dots
            s = u_part[urep] + i_part[flat] + c_part
            if pair is not None and pair_rows is not None:
                s = s + pair @ pair_rows
            return s

        # the cross stack as a scalar recurrence
        alpha = np.ones(q * c, np.float32)
        for layer in self.cross:
            alpha = alpha * (dot_x0(layer["dots"]) + 1.0) + layer["beta_dot_w"]

        h = None
        if self.P1 is not None:
            h = self.Q1[urep] + self.P1[flat] + self.c1
            if pair is not None and self.pair1 is not None:
                h = h + pair @ self.pair1
            h = np.maximum(h, 0.0)
            for w, b in self.deep_rest:
                h = np.maximum(h @ w + b, 0.0)

        outs = []
        for hd in (self.heads if need_rating else self.heads[:1]):
            logit = alpha * dot_x0(hd["cross_dots"]) + hd["beta_dot"]
            if h is not None:
                logit = logit + h @ hd["deep"]
            outs.append((logit + hd["b"]).reshape(q, c))
        if not need_rating:
            outs.append(None)
        return tuple(outs)

    def ctr_logits(self, uids: np.ndarray, cands: np.ndarray) -> np.ndarray:
        """uids [Q], cands [Q, C] -> CTR logits [Q, C]."""
        return self.logits(uids, cands, need_rating=False)[0]


class RecommendationService:
    """``backend``: ``"device"`` or ``"auto"`` (the same thing here),
    ``"native"`` (the host; ``device`` is not used), ``"exported"``
    (retrieval through the artifact at ``exported_path``, default
    ``<model_dir>/retrieve.pt2``, loaded onto ``device``) or
    ``"sharded"`` (the catalog row-sharded over ``mesh_ctx``, by default
    ``make_mesh(model_parallel=<ranks>, data_parallel=1)``, made at load;
    ``device`` is the rank's: ``"cuda"`` is card ``LOCAL_RANK``).
    ``device``: ``"cuda"`` (default; raises if absent) or ``"cpu"``."""

    def __init__(self, model_dir: str, backend: str = "auto",
                 approx_search_threshold: int = 1_000_000,
                 rerank_candidates: int = 0,
                 rerank_ctr_weight: float = 0.25,
                 rerank_rating_weight: float = 0.0,
                 int8_catalog: bool = False,
                 device: DeviceLike = "cuda",
                 exported_path: Optional[str] = None,
                 mesh_ctx=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.exported_path = exported_path
        self._exported_fn = None
        self._exported_k = 0
        self.mesh_ctx = mesh_ctx
        self._sharded: Optional[ShardedIndex] = None
        # the host backend asks for no device (and so touches no CUDA state)
        if backend == "native":
            self.device = torch.device("cpu")
        elif backend == "sharded":
            self.device = mesh_ctx.device if mesh_ctx is not None else rank_device(device)
        else:
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
        # host copies: the numpy towers and trunk of the host routes
        self._encoder_np = None
        self._model_np = None
        self._fast_rerank: Optional[_FastRerank] = None
        self._items_norm: Optional[np.ndarray] = None
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
        if self.backend == "native":
            self._encoder_np = params_to_numpy(self.encoder_params)
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
                if self.backend in HOST_RERANK_BACKENDS:
                    self._model_np = params_to_numpy(self.model_params)
                    self._fast_rerank = _FastRerank.build(
                        self._model_np, self.config.model, self.feature_engineer,
                        len(self.user_id_map), len(self.item_id_map),
                        self._tower_np, self._heads_exact_for_check)
                    if self._fast_rerank is not None:
                        logger.info("fast rerank active (precomputed towers, separable "
                                    "cross, feature split)")
        self.index = RetrievalIndex.load(os.path.join(d, "index.npz"), self.device)
        if self.backend == "native":
            self._items_norm = _l2_normalize_np(self.index.item_embeddings_np)
        if self.backend == "exported":
            self._load_exported()
        if self.backend == "sharded":
            if self.mesh_ctx is None:
                self.mesh_ctx = make_mesh(model_parallel=world_size(self.device),
                                          data_parallel=1, device=self.device)
            self._sharded = self.index.shard(self.mesh_ctx, int8=self.int8_catalog)
        self._popular = [int(r) for r in self.index.item_raw_ids[:200]]
        self._ready = True
        logger.info("loaded model from %s (%d users, %d items), backend %s on %s",
                    d, len(self.user_id_map), len(self.item_id_map), self.backend,
                    self.device)
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

    # ---- host (numpy) towers and trunk ------------------------------
    def _tower_np(self, params, table_key: str, tower_key: str,
                  ids: np.ndarray) -> np.ndarray:
        """Numpy tower forward in fp32 (inference mode)."""
        table = np.asarray(params[table_key])
        rows = table[np.clip(ids, 0, table.shape[0] - 1)]
        h = rows.astype(np.float32)
        tower = params[tower_key]
        n = len(tower)
        for i in range(n):
            layer = tower[f"layer_{i}"]
            h = h @ np.asarray(layer["w"]) + np.asarray(layer["b"])
            if i < n - 1:
                h = np.maximum(h, 0.0)
        if self.config.model.tower_residual:
            h = h + rows
        return h

    def _user_embedding_np(self, ids: np.ndarray) -> np.ndarray:
        """The host backend's user tower: one small MLP per request."""
        return self._tower_np(self._encoder_np, "user_table", "user_tower", ids)

    def _trunk_np(self, user_ids: np.ndarray, item_ids: np.ndarray,
                  dense: Optional[np.ndarray] = None) -> np.ndarray:
        """Numpy DCN trunk feature (towers -> cross + deep concat,
        inference mode), shared by both heads."""
        p = self._model_np
        tw = p["towers"]
        u = self._tower_np(tw, "user_table", "user_tower", user_ids)
        v = self._tower_np(tw, "item_table", "item_tower", item_ids)
        parts = [u, v] if dense is None else [u, v, dense]
        x0 = np.concatenate(parts, axis=-1).astype(np.float32)
        xl = x0
        for i in range(self.config.model.cross_layers):
            layer = p["dcn"]["cross"][f"layer_{i}"]
            xw = (xl @ np.asarray(layer["w"]))[:, None]
            xl = x0 * xw + np.asarray(layer["b"]) + xl
        deep = p["dcn"]["deep"]
        if deep:
            h = x0
            for i in range(len(deep)):
                layer = deep[f"layer_{i}"]
                h = np.maximum(h @ np.asarray(layer["w"]) + np.asarray(layer["b"]), 0.0)
            return np.concatenate([xl, h], axis=-1)
        return xl

    def _head_np(self, feat: np.ndarray, name: str) -> np.ndarray:
        head = self._model_np[name]
        return (feat @ np.asarray(head["w"]) + np.asarray(head["b"]))[:, 0]

    def _ctr_logits_np(self, user_ids: np.ndarray, item_ids: np.ndarray,
                       dense: Optional[np.ndarray] = None) -> np.ndarray:
        return self._head_np(self._trunk_np(user_ids, item_ids, dense), "ctr_head")

    def _dense_features(self, flat_u: np.ndarray, flat_i: np.ndarray) -> Optional[np.ndarray]:
        """Each pair's engineered features at the end-of-train timestamp
        (None for a model without dense features)."""
        if self.config.model.dense_features <= 0:
            return None
        eng = self.feature_engineer
        return eng.transform_scaled(flat_u, flat_i, np.full(len(flat_u), eng.t_ref))

    def _heads_exact_for_check(self, flat_u: np.ndarray, flat_i: np.ndarray) -> np.ndarray:
        """Exact per-pair (ctr, rating) [N, 2] on the host: what
        ``_FastRerank``'s build checks both heads against."""
        feat = self._trunk_np(flat_u, flat_i, self._dense_features(flat_u, flat_i))
        return np.stack([self._head_np(feat, "ctr_head"),
                         self._head_np(feat, "rating_head")], axis=-1)

    def _ctr_exact_for_check(self, flat_u: np.ndarray, flat_i: np.ndarray) -> np.ndarray:
        """Exact per-pair CTR logits on the host."""
        return self._heads_exact_for_check(flat_u, flat_i)[:, 0]

    # ---- core ops --------------------------------------------------
    @torch.inference_mode()
    def _user_embedding(self, dense_uid):
        ids = np.atleast_1d(np.asarray(dense_uid))
        if self.backend == "native":
            return self._user_embedding_np(ids)
        return TwoTower.user_embed(self.encoder_params, torch.as_tensor(ids, device=self.device),
                                   self.config.model)

    def _search_route(self) -> str:
        if self.backend in ("exported", "native", "sharded"):
            return self.backend
        if self.int8_catalog:
            return "int8"
        n_index_rows = self.index.item_embeddings_np.shape[0]
        if self.approx_search_threshold and n_index_rows > self.approx_search_threshold:
            return "approx"
        return "exact"

    def _search_native(self, u: np.ndarray, k: int):
        """Cosine top-k on the host: one BLAS product, then argpartition."""
        q = _l2_normalize_np(np.asarray(u, np.float32))
        scores = q @ self._items_norm.T
        part = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1)
        idx = np.take_along_axis(part, order, axis=1)
        return np.take_along_axis(scores, idx, axis=1), idx

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
        if route == "native":
            return self._search_native(u, k)
        if route == "sharded":
            return self._sharded.search(u, k)
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
        score + ctr weight * CTR logit [+ rating weight * rating]. The
        heads come from ``_FastRerank`` where it was built (the host
        backends), else from the exact numpy trunk (``"native"``), else
        from a per-pair ``MultiTaskModel.apply`` on the device."""
        idx = np.asarray(idx)
        q, c = idx.shape
        w_r = self.rerank_rating_weight
        if self._fast_rerank is not None:
            ctr, rating = self._fast_rerank.logits(np.asarray(dense_uids), idx,
                                                   need_rating=bool(w_r))
        else:
            users = np.repeat(np.asarray(dense_uids), c)
            items = idx.reshape(-1)
            dense = self._dense_features(users, items)
            if self.backend == "native":
                feat = self._trunk_np(users, items, dense)
                ctr = self._head_np(feat, "ctr_head").reshape(q, c)
                rating = self._head_np(feat, "rating_head").reshape(q, c) if w_r else 0.0
            else:
                out = MultiTaskModel.apply(
                    self.model_params, self.config.model,
                    torch.as_tensor(users, device=self.device),
                    torch.as_tensor(items, device=self.device),
                    dense=None if dense is None else torch.as_tensor(dense, device=self.device))
                ctr = out.ctr_logit.cpu().numpy().reshape(q, c)
                rating = out.rating_pred.cpu().numpy().reshape(q, c) if w_r else 0.0
        combined = np.asarray(scores) + self.rerank_ctr_weight * ctr
        if w_r:
            combined = combined + w_r * rating
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
            u, sel = _l2_normalize_np(u), _l2_normalize_np(sel)
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
        scorer = "device" if self.backend == "auto" else self.backend
        return {
            "model_version": self.model_version,
            "model_dir": self.model_dir,
            "bundle_mtime": mtime,
            "n_users": len(self.user_id_map),
            "n_items": len(self.item_id_map),
            "embedding_dim": self.config.model.embedding_dim if self.config else None,
            "backend": f"recsys_tpu_torch {scorer} scorer ({self.device.type})",
            "search": (_SEARCH_ROUTES[self._search_route()]
                       if self.index is not None else None),
            "fast_rerank": self._fast_rerank is not None,
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
