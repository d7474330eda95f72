"""Engineered dense features for the DCN ranking input, in numpy (the
port's own copy of ``recsys_tpu/data/features.py``: the same columns,
state layout and ``STATE_VERSION``, so a ``features.npz`` written by
either package loads in the other).

Feature groups:

* time of day (hour sin/cos, time bucket, weekend);
* user stats: count / mean / std / min / max / nunique / range;
* item stats, the same;
* temporal: activity span in days, rating velocity, days since first
  and last activity, item age, recent (90-day) popularity and its trend;
* interaction: rating consistency 1/(1+std), polarization,
  |log1p(user count) - log1p(item count)|;
* the user's rating-weighted genre preference . the item's genres;
* external user / item side tables (a dense-id gather);
* standardization fitted on train, a clip at ``clip_std`` train-sigmas,
  NaN/inf -> 0.

Every statistic is fitted on the train split only and applied to every
split. ``ModelConfig.dense_features = FeatureEngineer.n_features(...)``
feeds the matrix into the DCN input; the fitted state ships in the
inference bundle (``state_dict`` / ``from_state``) so that serving-time
rerank computes the features the model trained on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

SECONDS_PER_DAY = 86_400.0


class StandardScaler:
    """Fit on train, transform anywhere (sklearn's StandardScaler)."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self.mean_ = x.mean(axis=0)
        self.scale_ = x.std(axis=0)
        self.scale_ = np.where(self.scale_ < 1e-12, 1.0, self.scale_)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) / self.scale_


def _group_stats(ids: np.ndarray, values: np.ndarray, size: int):
    """count/sum/mean/std/min/max per group via bincount + sort-splits."""
    cnt = np.bincount(ids, minlength=size).astype(np.float64)
    s = np.bincount(ids, weights=values, minlength=size)
    mean = np.divide(s, cnt, out=np.zeros_like(s), where=cnt > 0)
    sq = np.bincount(ids, weights=values.astype(np.float64) ** 2, minlength=size)
    var = np.maximum(np.divide(sq, cnt, out=np.zeros_like(sq), where=cnt > 0) - mean ** 2, 0)
    std = np.sqrt(var)
    mn = np.full(size, np.inf)
    np.minimum.at(mn, ids, values)
    mx = np.full(size, -np.inf)
    np.maximum.at(mx, ids, values)
    mn[~np.isfinite(mn)] = 0.0
    mx[~np.isfinite(mx)] = 0.0
    return cnt, mean, std, mn, mx


def _group_minmax_ts(ids: np.ndarray, ts: np.ndarray, size: int):
    first = np.full(size, np.inf)
    np.minimum.at(first, ids, ts)
    last = np.full(size, -np.inf)
    np.maximum.at(last, ids, ts)
    first[~np.isfinite(first)] = 0.0
    last[~np.isfinite(last)] = 0.0
    return first, last


class FeatureEngineer:
    """fit(train columns) -> transform(any split columns) -> feature
    matrix [N, F] + names."""

    #: bump when the emitted feature columns change (serving-side
    #: ``from_state`` refuses a mismatched version instead of silently
    #: computing different features than the model trained on). v2:
    #: log_pop_match corrected to the reference's
    #: |log1p(user_count) - log1p(item_count)| semantics
    #: (``src/data_processing.py:180-184``) + external side tables.
    STATE_VERSION = 2

    def __init__(self, n_users: int, n_items: int,
                 item_genres: Optional[np.ndarray] = None,
                 standardize: bool = True, clip_std: float = 10.0,
                 user_side: Optional[np.ndarray] = None,
                 item_side: Optional[np.ndarray] = None,
                 user_side_names: Optional[List[str]] = None,
                 item_side_names: Optional[List[str]] = None):
        self.n_users = n_users
        self.n_items = n_items
        self.item_genres = item_genres  # [n_items, G] multi-hot
        # external side tables (src/data_processing.py:243-258): the
        # reference left-joins optional user/item feature DataFrames on
        # the id column; here the join is a dense-id row gather from a
        # [n_users, Fu] / [n_items, Fi] array (ids are already remapped
        # to dense ints in preprocessing, so merge == indexing).
        self.user_side = None if user_side is None else np.asarray(user_side, np.float64)
        self.item_side = None if item_side is None else np.asarray(item_side, np.float64)
        if self.user_side is not None and self.user_side.shape[0] != n_users:
            raise ValueError(
                f"user_side has {self.user_side.shape[0]} rows, expected {n_users}")
        if self.item_side is not None and self.item_side.shape[0] != n_items:
            raise ValueError(
                f"item_side has {self.item_side.shape[0]} rows, expected {n_items}")
        self.user_side_names = list(user_side_names) if user_side_names else (
            [f"user_ext_{j}" for j in range(self.user_side.shape[1])]
            if self.user_side is not None else [])
        self.item_side_names = list(item_side_names) if item_side_names else (
            [f"item_ext_{j}" for j in range(self.item_side.shape[1])]
            if self.item_side is not None else [])
        self.standardize = standardize
        # post-standardization clip (in train-σ units). Temporal holdout
        # splits extrapolate: days-since-last-activity / item-age on val
        # rows reach ~70σ of the train distribution, which the DCN cross
        # term (x0 ⊙ (x·w)) amplifies quadratically — unclipped, eval
        # rating RMSE explodes while train stays healthy.
        self.clip_std = clip_std
        self.fitted = False

    @staticmethod
    def n_features(with_genres: bool = True, n_user_side: int = 0,
                   n_item_side: int = 0) -> int:
        """Width of the feature matrix this engineer emits — the value
        to put in ``ModelConfig.dense_features``."""
        return (29 if with_genres else 28) + n_user_side + n_item_side

    # ---- fit on train ----------------------------------------------
    def fit(self, uid: np.ndarray, mid: np.ndarray, rating: np.ndarray,
            ts: np.ndarray) -> "FeatureEngineer":
        nU, nI = self.n_users, self.n_items
        (self.u_cnt, self.u_mean, self.u_std, self.u_min, self.u_max) = \
            _group_stats(uid, rating, nU)
        (self.i_cnt, self.i_mean, self.i_std, self.i_min, self.i_max) = \
            _group_stats(mid, rating, nI)
        # nunique items per user / users per item
        pair = np.unique(np.stack([uid, mid], axis=1), axis=0)
        self.u_nunique = np.bincount(pair[:, 0], minlength=nU).astype(np.float64)
        self.i_nunique = np.bincount(pair[:, 1], minlength=nI).astype(np.float64)
        # temporal caches
        self.u_first, self.u_last = _group_minmax_ts(uid, ts, nU)
        self.i_first, self.i_last = _group_minmax_ts(mid, ts, nI)
        self.t_ref = float(ts.max())  # "now" = end of train
        # recent (90-day) item popularity + trend (recent vs overall rate)
        recent = ts >= self.t_ref - 90 * SECONDS_PER_DAY
        self.i_recent_cnt = np.bincount(mid[recent], minlength=nI).astype(np.float64)
        span_days = np.maximum((self.i_last - self.i_first) / SECONDS_PER_DAY, 1.0)
        overall_rate = self.i_cnt / span_days
        recent_rate = self.i_recent_cnt / 90.0
        self.i_pop_trend = np.divide(
            recent_rate, overall_rate,
            out=np.zeros_like(recent_rate), where=overall_rate > 0,
        )
        # user genre preference: rating-weighted genre vector (train-only,
        # src/data_processing.py:189-240)
        if self.item_genres is not None:
            G = self.item_genres.shape[1]
            w = rating.astype(np.float64)
            pref = np.zeros((nU, G))
            np.add.at(pref, uid, w[:, None] * self.item_genres[mid])
            denom = np.maximum(np.bincount(uid, weights=w, minlength=nU), 1e-9)
            self.user_genre_prefs = pref / denom[:, None]
        else:
            self.user_genre_prefs = None
        self.fitted = True
        return self

    # ---- transform any split ---------------------------------------
    def feature_names(self) -> List[str]:
        names = [
            "hour_sin", "hour_cos", "is_weekend", "time_bucket",
            "user_count", "user_mean", "user_std", "user_min", "user_max",
            "user_nunique", "user_range",
            "item_count", "item_mean", "item_std", "item_min", "item_max",
            "item_nunique", "item_range",
            "user_activity_days", "user_rating_velocity",
            "user_days_since_first", "user_days_since_last",
            "item_age_days", "item_recent_popularity", "item_pop_trend",
            "rating_consistency", "user_polarization", "log_pop_match",
        ]
        if self.user_genre_prefs is not None:
            names.append("user_genre_match")
        names.extend(self.user_side_names)
        names.extend(self.item_side_names)
        return names

    def transform(self, uid: np.ndarray, mid: np.ndarray,
                  ts: np.ndarray) -> np.ndarray:
        assert self.fitted, "call fit() first"
        hour = (ts % SECONDS_PER_DAY) / 3600.0
        dow = ((ts // SECONDS_PER_DAY) + 4) % 7  # epoch day 0 = Thursday
        cols = {}
        cols["hour_sin"] = np.sin(2 * np.pi * hour / 24.0)
        cols["hour_cos"] = np.cos(2 * np.pi * hour / 24.0)
        cols["is_weekend"] = (dow >= 5).astype(np.float64)
        cols["time_bucket"] = (hour // 6).astype(np.float64)  # night/morning/afternoon/evening

        u, i = uid, mid
        cols["user_count"] = self.u_cnt[u]
        cols["user_mean"] = self.u_mean[u]
        cols["user_std"] = self.u_std[u]
        cols["user_min"] = self.u_min[u]
        cols["user_max"] = self.u_max[u]
        cols["user_nunique"] = self.u_nunique[u]
        cols["user_range"] = self.u_max[u] - self.u_min[u]
        cols["item_count"] = self.i_cnt[i]
        cols["item_mean"] = self.i_mean[i]
        cols["item_std"] = self.i_std[i]
        cols["item_min"] = self.i_min[i]
        cols["item_max"] = self.i_max[i]
        cols["item_nunique"] = self.i_nunique[i]
        cols["item_range"] = self.i_max[i] - self.i_min[i]

        span = np.maximum((self.u_last[u] - self.u_first[u]) / SECONDS_PER_DAY, 0.0)
        cols["user_activity_days"] = span
        cols["user_rating_velocity"] = self.u_cnt[u] / np.maximum(span, 1.0)
        cols["user_days_since_first"] = (ts - self.u_first[u]) / SECONDS_PER_DAY
        cols["user_days_since_last"] = (ts - self.u_last[u]) / SECONDS_PER_DAY
        cols["item_age_days"] = (ts - self.i_first[i]) / SECONDS_PER_DAY
        cols["item_recent_popularity"] = self.i_recent_cnt[i]
        cols["item_pop_trend"] = self.i_pop_trend[i]

        cols["rating_consistency"] = 1.0 / (1.0 + self.u_std[u])
        cols["user_polarization"] = np.abs(self.u_mean[u] - 3.0)
        # user-item popularity match (src/data_processing.py:180-184):
        # |log1p(user_rating_count) - log1p(item_rating_count)| — small
        # when a user's activity level matches the item's popularity tier
        cols["log_pop_match"] = np.abs(
            np.log1p(self.u_cnt[u]) - np.log1p(self.i_cnt[i])
        )

        if self.user_genre_prefs is not None:
            cols["user_genre_match"] = np.einsum(
                "ng,ng->n", self.user_genre_prefs[u], self.item_genres[i]
            )

        # external side features: dense-id gather (the merge of
        # src/data_processing.py:243-258)
        for j, name in enumerate(self.user_side_names):
            cols[name] = self.user_side[u, j]
        for j, name in enumerate(self.item_side_names):
            cols[name] = self.item_side[i, j]

        mat = np.stack([cols[n] for n in self.feature_names()], axis=1)
        mat = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
        return mat.astype(np.float32)

    # ---- fit+standardize pipeline ----------------------------------
    def fit_transform_splits(
        self, bundle: Dict[str, np.ndarray]
    ) -> Dict[str, np.ndarray]:
        """Convenience: fit on train, emit standardized features for
        every split (scaler fit on train only, ``:261-273``)."""
        self.fit(
            bundle["train/user_id"], bundle["train/movie_id"],
            bundle["train/rating"], bundle["train/timestamp"].astype(np.float64),
        )
        feats = {
            split: self.transform(
                bundle[f"{split}/user_id"], bundle[f"{split}/movie_id"],
                bundle[f"{split}/timestamp"].astype(np.float64),
            )
            for split in ("train", "val", "test")
        }
        if self.standardize:
            scaler = StandardScaler().fit(feats["train"])
            feats = {k: self._clip(scaler.transform(v)) for k, v in feats.items()}
            self.scaler = scaler
        return feats

    def _clip(self, mat: np.ndarray) -> np.ndarray:
        if self.clip_std:
            mat = np.clip(mat, -self.clip_std, self.clip_std)
        return mat.astype(np.float32)

    def transform_scaled(self, uid: np.ndarray, mid: np.ndarray,
                         ts: np.ndarray) -> np.ndarray:
        """transform() + the train-fitted scaler + σ-clip — the
        serving-time entry point (identical to what the model saw in
        training)."""
        mat = self.transform(uid, mid, ts)
        if self.standardize and hasattr(self, "scaler"):
            mat = self._clip(self.scaler.transform(mat))
        return mat

    # ---- serialization (ships in the inference bundle) ---------------
    _STATE_KEYS = (
        "u_cnt", "u_mean", "u_std", "u_min", "u_max", "u_nunique",
        "u_first", "u_last",
        "i_cnt", "i_mean", "i_std", "i_min", "i_max", "i_nunique",
        "i_first", "i_last", "i_recent_cnt", "i_pop_trend",
    )

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Fitted state as a flat array dict (npz-serializable), so the
        serving layer reranks with the exact training-time features."""
        assert self.fitted, "call fit() first"
        state: Dict[str, np.ndarray] = {
            k: np.asarray(getattr(self, k)) for k in self._STATE_KEYS
        }
        state["version"] = np.int64(self.STATE_VERSION)
        state["t_ref"] = np.float64(self.t_ref)
        state["clip_std"] = np.float64(self.clip_std)
        state["meta"] = np.array(
            [self.n_users, self.n_items, int(self.standardize)], np.int64
        )
        if self.item_genres is not None:
            state["item_genres"] = np.asarray(self.item_genres)
            state["user_genre_prefs"] = np.asarray(self.user_genre_prefs)
        if self.user_side is not None:
            state["user_side"] = np.asarray(self.user_side)
            state["user_side_names"] = np.array(self.user_side_names)
        if self.item_side is not None:
            state["item_side"] = np.asarray(self.item_side)
            state["item_side_names"] = np.array(self.item_side_names)
        if self.standardize and hasattr(self, "scaler"):
            state["scaler_mean"] = np.asarray(self.scaler.mean_)
            state["scaler_scale"] = np.asarray(self.scaler.scale_)
        return state

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray]) -> "FeatureEngineer":
        version = int(state["version"]) if "version" in state else 1
        if version != cls.STATE_VERSION:
            raise ValueError(
                f"feature state version {version} != code version "
                f"{cls.STATE_VERSION}: the bundle's features were computed "
                "by a different feature pipeline — retrain or re-export "
                "(serving with mismatched features silently skews the "
                "ranking heads)"
            )
        n_users, n_items, standardize = (int(v) for v in state["meta"])
        eng = cls(
            n_users, n_items,
            item_genres=(state["item_genres"] if "item_genres" in state else None),
            standardize=bool(standardize),
            clip_std=float(state["clip_std"]) if "clip_std" in state else 10.0,
            user_side=state["user_side"] if "user_side" in state else None,
            item_side=state["item_side"] if "item_side" in state else None,
            user_side_names=(
                [str(s) for s in state["user_side_names"]]
                if "user_side_names" in state else None),
            item_side_names=(
                [str(s) for s in state["item_side_names"]]
                if "item_side_names" in state else None),
        )
        for k in cls._STATE_KEYS:
            setattr(eng, k, np.asarray(state[k]))
        eng.t_ref = float(state["t_ref"])
        if eng.item_genres is not None:
            eng.user_genre_prefs = np.asarray(state["user_genre_prefs"])
        else:
            eng.user_genre_prefs = None
        if "scaler_mean" in state:
            eng.scaler = StandardScaler()
            eng.scaler.mean_ = np.asarray(state["scaler_mean"])
            eng.scaler.scale_ = np.asarray(state["scaler_scale"])
        eng.fitted = True
        return eng


def side_tables_from_bundle(bundle: Dict[str, np.ndarray]):
    """Build the MovieLens external side tables from the preprocessed
    bundle's demographic/metadata columns — the concrete instance of the
    reference's user_features/item_features merge inputs
    (``src/data_processing.py:243-258``; the raw columns come from
    ``users.dat``/``movies.dat``, ``src/preprocessing.py:49-64``).

    Returns ``(user_side [nU, 3], item_side [nI, 1], user_names,
    item_names)`` or ``(None, None, [], [])`` when the bundle lacks the
    demographic columns (synthetic bundles without them)."""
    needed = ("meta/user_gender", "meta/user_age", "meta/user_occupation",
              "meta/movie_year_norm")
    if not all(k in bundle for k in needed):
        return None, None, [], []
    user_side = np.stack(
        [np.asarray(bundle["meta/user_gender"], np.float64),
         np.asarray(bundle["meta/user_age"], np.float64),
         np.asarray(bundle["meta/user_occupation"], np.float64)], axis=1)
    item_side = np.asarray(bundle["meta/movie_year_norm"], np.float64)[:, None]
    return (user_side, item_side,
            ["user_gender", "user_age", "user_occupation"],
            ["item_year_norm"])


def make_engineer(bundle: Dict[str, np.ndarray], n_dense: int,
                  standardize: bool = True,
                  clip_std: float = 10.0) -> "FeatureEngineer":
    """Construct a FeatureEngineer whose emitted width matches
    ``n_dense`` (= ``ModelConfig.dense_features``), deciding from the
    width whether external side tables are included. Raises when no
    construction matches — a loud failure instead of silently feeding a
    model features it was not trained on. The single construction point
    for trainer/evaluator/CLI fallbacks."""
    genres = bundle["meta/movie_genres"] if "meta/movie_genres" in bundle else None
    base = FeatureEngineer.n_features(with_genres=genres is not None)
    if n_dense == base:
        return FeatureEngineer(
            int(bundle["meta/n_users"]), int(bundle["meta/n_movies"]),
            item_genres=genres, standardize=standardize, clip_std=clip_std)
    u_side, i_side, u_names, i_names = side_tables_from_bundle(bundle)
    if u_side is not None:
        with_side = FeatureEngineer.n_features(
            with_genres=genres is not None,
            n_user_side=u_side.shape[1], n_item_side=i_side.shape[1])
        if n_dense == with_side:
            return FeatureEngineer(
                int(bundle["meta/n_users"]), int(bundle["meta/n_movies"]),
                item_genres=genres, standardize=standardize,
                clip_std=clip_std, user_side=u_side, item_side=i_side,
                user_side_names=u_names, item_side_names=i_names)
    raise ValueError(
        f"dense_features={n_dense} matches no FeatureEngineer layout for "
        f"this bundle (base width {base}); was the model trained with a "
        "different feature pipeline?")
