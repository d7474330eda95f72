"""Offline preprocessing: raw MovieLens columns -> the dense-int training
bundle, in numpy only (the counterpart of
``recsys_tpu/data/preprocessing.py``, which works on DataFrames; the
bundle's keys, dtypes and values are the same).

* timestamp -> hour, day of week (Monday = 0) and year, in UTC;
* sequential dense ids for users and movies (sorted raw ids);
* genre multi-hot, demographic codes, the movie year from the title
  (median-filled, min-max normalized), ``age_at_rating``;
* a temporal 80/10/10 split (a stable sort on the timestamp);
* train-only per-user and per-movie count / mean / std;
* the implicit label ``rating >= threshold``.

The result is a flat dict ``{f"{split}/{column}": array, "meta/...":
array}``, saved as ``.npz``.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, Optional

import numpy as np

from recsys_tpu_torch.data.movielens import GENRES, Table, load_movielens_data

logger = logging.getLogger(__name__)

SPLITS = ("train", "val", "test")
_YEAR_RE = re.compile(r"\((\d{4})\)")
_AGE_BUCKETS = [1, 18, 25, 35, 45, 50, 56]
_SECONDS_PER_HOUR, _SECONDS_PER_DAY = 3600, 86_400


def _time_fields(ts: np.ndarray):
    """Unix seconds -> (hour, day of week with Monday = 0, year), int32,
    in UTC; 1970-01-01 was a Thursday (day 3)."""
    hour = (ts // _SECONDS_PER_HOUR) % 24
    dow = (ts // _SECONDS_PER_DAY + 3) % 7
    year = ts.astype("datetime64[s]").astype("datetime64[Y]").astype(np.int64) + 1970
    return hour.astype(np.int32), dow.astype(np.int32), year.astype(np.int32)


def _row_of(ids: np.ndarray) -> Dict[int, int]:
    """raw id -> its first row in a table."""
    out: Dict[int, int] = {}
    for row, raw in enumerate(ids.tolist()):
        out.setdefault(raw, row)
    return out


def preprocessing_pipeline(
    ratings: Table,
    movies: Table,
    users: Table,
    implicit_threshold: float = 4.0,
    train_frac: float = 0.8,
    val_frac: float = 0.1,
) -> Dict[str, np.ndarray]:
    """Run the full pipeline on column dicts (``movielens.read_dat``'s
    tables); returns the flat columnar bundle."""
    raw_u = np.asarray(ratings["user_id"])
    raw_m = np.asarray(ratings["movie_id"])
    rating = np.asarray(ratings["rating"])
    ts = np.asarray(ratings["timestamp"]).astype(np.int64)

    # ---- sequential dense id remap ------------------------------------
    uniq_users = np.unique(raw_u)
    uniq_movies = np.unique(raw_m)
    uid = np.searchsorted(uniq_users, raw_u).astype(np.int32)
    mid = np.searchsorted(uniq_movies, raw_m).astype(np.int32)

    # ---- temporal fields ----------------------------------------------
    hour, dayofweek, rating_year = _time_fields(ts)

    # ---- movie-side features (genre multi-hot, year) ------------------
    movie_row = _row_of(np.asarray(movies["movie_id"]))
    n_movies = len(uniq_movies)
    genre_mh = np.zeros((n_movies, len(GENRES)), np.float32)
    years = np.full(n_movies, np.nan, np.float32)
    gidx = {g: i for i, g in enumerate(GENRES)}
    for dense, raw_id in enumerate(uniq_movies.tolist()):
        row = movie_row.get(raw_id)
        if row is None:
            continue
        for g in str(movies["genres"][row]).split("|"):
            if g in gidx:
                genre_mh[dense, gidx[g]] = 1.0
        m = _YEAR_RE.search(str(movies["title"][row]))
        if m:
            years[dense] = float(m.group(1))
    med = np.nanmedian(years) if np.isfinite(years).any() else 1990.0
    years = np.where(np.isnan(years), med, years)
    yr_min, yr_max = years.min(), years.max()
    movie_year_norm = ((years - yr_min) / max(yr_max - yr_min, 1.0)).astype(np.float32)

    # ---- user-side demographics -----------------------------------------
    user_row = _row_of(np.asarray(users["user_id"]))
    n_users = len(uniq_users)
    u_gender = np.zeros(n_users, np.int32)
    u_age = np.zeros(n_users, np.int32)
    u_occ = np.zeros(n_users, np.int32)
    age_code = {a: i for i, a in enumerate(_AGE_BUCKETS)}
    for dense, raw_id in enumerate(uniq_users.tolist()):
        row = user_row.get(raw_id)
        if row is None:
            continue
        u_gender[dense] = 1 if str(users["gender"][row]) == "M" else 0
        u_age[dense] = age_code.get(int(users["age"][row]), 0)
        u_occ[dense] = int(users["occupation"][row])
    age_years = np.array(_AGE_BUCKETS, np.float32)
    age_at_rating = (age_years[u_age[uid]] + (rating_year - 2000)).astype(np.float32)

    # ---- temporal split -------------------------------------------------
    order = np.argsort(ts, kind="stable")
    cols = {"uid": uid, "mid": mid, "rating": rating, "timestamp": ts, "hour": hour,
            "dayofweek": dayofweek, "age_at_rating": age_at_rating}
    cols = {k: v[order] for k, v in cols.items()}
    n = len(order)
    n_train = int(n * train_frac)
    n_val = int(n * val_frac)
    bounds = {"train": (0, n_train), "val": (n_train, n_train + n_val),
              "test": (n_train + n_val, n)}

    # ---- train-only per-entity stats ------------------------------------
    def _stats(ids, values, size):
        cnt = np.bincount(ids, minlength=size).astype(np.float32)
        s = np.bincount(ids, weights=values, minlength=size).astype(np.float32)
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), values.mean())
        sq = np.bincount(ids, weights=values ** 2, minlength=size).astype(np.float32)
        var = np.maximum(sq / np.maximum(cnt, 1) - mean ** 2, 0.0)
        std = np.where(cnt > 1, np.sqrt(var), 0.0)
        return cnt, mean.astype(np.float32), std.astype(np.float32)

    tr_r = cols["rating"][:n_train].astype(np.float32)
    u_cnt, u_mean, u_std = _stats(cols["uid"][:n_train], tr_r, n_users)
    m_cnt, m_mean, m_std = _stats(cols["mid"][:n_train], tr_r, n_movies)

    # ---- implicit label --------------------------------------------------
    cols["y_implicit"] = (cols["rating"] >= implicit_threshold).astype(np.float32)

    out: Dict[str, np.ndarray] = {}
    per_row_cols = {
        "user_id": ("uid", np.int32),
        "movie_id": ("mid", np.int32),
        "rating": ("rating", np.float32),
        "y_implicit": ("y_implicit", np.float32),
        "timestamp": ("timestamp", np.int64),
        "hour": ("hour", np.int32),
        "dayofweek": ("dayofweek", np.int32),
        "age_at_rating": ("age_at_rating", np.float32),
    }
    for split, (lo, hi) in bounds.items():
        for name, (col, dtype) in per_row_cols.items():
            out[f"{split}/{name}"] = cols[col][lo:hi].astype(dtype)

    out["meta/n_users"] = np.int64(n_users)
    out["meta/n_movies"] = np.int64(n_movies)
    out["meta/implicit_threshold"] = np.float32(implicit_threshold)
    out["meta/user_raw_ids"] = uniq_users.astype(np.int64)
    out["meta/movie_raw_ids"] = uniq_movies.astype(np.int64)
    out["meta/movie_genres"] = genre_mh
    out["meta/movie_year_norm"] = movie_year_norm
    out["meta/user_gender"] = u_gender
    out["meta/user_age"] = u_age
    out["meta/user_occupation"] = u_occ
    out["meta/user_count"] = u_cnt
    out["meta/user_mean"] = u_mean
    out["meta/user_std"] = u_std
    out["meta/movie_count"] = m_cnt
    out["meta/movie_mean"] = m_mean
    out["meta/movie_std"] = m_std
    return out


def check_preprocessing_quality(bundle: Dict[str, np.ndarray]) -> Dict[str, float]:
    """QA invariants, raising ``ValueError`` when one fails: ids in range,
    finite labels, splits in time order. -> rows per split and cold-start
    users of val and test."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"preprocessing QA: {msg}")

    n_users = int(bundle["meta/n_users"])
    n_movies = int(bundle["meta/n_movies"])
    report: Dict[str, float] = {}
    train_users = np.unique(bundle["train/user_id"])
    for split in SPLITS:
        uid = bundle[f"{split}/user_id"]
        mid = bundle[f"{split}/movie_id"]
        require(uid.min() >= 0 and uid.max() < n_users, f"{split} uid out of range")
        require(mid.min() >= 0 and mid.max() < n_movies, f"{split} mid out of range")
        for col in ("rating", "y_implicit"):
            require(np.isfinite(bundle[f"{split}/{col}"]).all(), f"{split}/{col} non-finite")
        report[f"{split}_rows"] = float(len(uid))
        if split != "train":
            cold = np.setdiff1d(np.unique(uid), train_users)
            report[f"{split}_cold_start_users"] = float(len(cold))
    require(bundle["train/timestamp"].max() <= bundle["val/timestamp"].min(),
            "train rows after val rows")
    require(bundle["val/timestamp"].max() <= bundle["test/timestamp"].min(),
            "val rows after test rows")
    return report


def save_bundle(bundle: Dict[str, np.ndarray], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **bundle)


def load_bundle(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def run(
    data_dir: str,
    output_path: str,
    implicit_threshold: float = 4.0,
    synthetic_ratings: Optional[int] = None,
    synthetic_seed: int = 1,
) -> Dict[str, np.ndarray]:
    """End to end: load raw -> pipeline -> QA -> save."""
    raw = load_movielens_data(
        data_dir, synthetic_ratings=synthetic_ratings, synthetic_seed=synthetic_seed
    )
    bundle = preprocessing_pipeline(
        raw["ratings"], raw["movies"], raw["users"],
        implicit_threshold=implicit_threshold,
    )
    report = check_preprocessing_quality(bundle)
    logger.info("preprocessing QA: %s", json.dumps(report))
    save_bundle(bundle, output_path)
    logger.info("saved bundle -> %s", output_path)
    return bundle
