"""MovieLens-1M raw data: ``.dat`` parsing and deterministic synthetic
ratings, in numpy only (the counterpart of ``recsys_tpu/data/movielens.py``,
which reads through pandas).

A table is a dict of column arrays in place of a DataFrame:
``ratings[user_id, movie_id, rating, timestamp]`` (int64),
``movies[movie_id, title, genres]`` and ``users[user_id, gender, age,
occupation, zip]``, read from ``::``-separated latin-1 files. Integer
columns are int64; text columns are numpy unicode arrays.

A real ``ratings.dat`` (over 1 MB) is parsed by the native C++ parser
(``utils/native.py``; malformed lines are skipped, ratings come back
float64, as in the JAX package), or by :func:`read_ratings_dat` when the
library cannot be built. Without one (absent, or the stripped stub of
under 1 MB), :func:`synthesize_ratings` generates it from a seed: the same
draws from ``numpy.random.default_rng`` in the same order as the JAX
package, so one seed gives the same ratings in both packages.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

GENRES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

Table = Dict[str, np.ndarray]

# column names of each file, and which of them hold integers
MOVIE_COLUMNS = ("movie_id", "title", "genres")
USER_COLUMNS = ("user_id", "gender", "age", "occupation", "zip")
_INT_COLUMNS = {"movie_id", "user_id", "age", "occupation"}
# a real ratings.dat is larger than this; below it is a stripped stub
_REAL_RATINGS_BYTES = 1_000_000


def read_dat(path: str, names: Sequence[str], encoding: str = "latin-1") -> Table:
    """One ``::``-separated file -> {name: column}; a line splits into at
    most ``len(names)`` fields, blank lines are skipped. Integer columns
    (``_INT_COLUMNS``) become int64, the rest unicode strings."""
    with open(path, encoding=encoding, newline="") as f:
        lines = [ln.rstrip("\r") for ln in f.read().split("\n")]
    rows = [ln.split("::", len(names) - 1) for ln in lines if ln.strip()]
    for i, row in enumerate(rows):
        if len(row) != len(names):
            raise ValueError(f"{path}: line {i + 1} has {len(row)} fields, "
                             f"expected {len(names)}")
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {name: (np.array([int(v) for v in col], np.int64) if name in _INT_COLUMNS
                   else np.array(col, dtype=str))
            for name, col in zip(names, cols)}


def read_ratings_dat(path: str) -> Table:
    """``ratings.dat`` (``user::movie::rating::timestamp`` integers) ->
    four int64 columns, parsed in one pass by numpy."""
    with open(path, "rb") as f:
        text = f.read().replace(b"::", b" ").decode("ascii")
    flat = np.array(text.split(), dtype=np.int64)
    if flat.size % 4:
        raise ValueError(f"{path}: {flat.size} integers, not a multiple of 4")
    rows = flat.reshape(-1, 4)
    return {"user_id": rows[:, 0].copy(), "movie_id": rows[:, 1].copy(),
            "rating": rows[:, 2].copy(), "timestamp": rows[:, 3].copy()}


def load_movielens_data(
    data_dir: str,
    synthetic_ratings: Optional[int] = None,
    synthetic_seed: int = 1,
) -> Dict[str, Table]:
    """Load ``movies.dat`` / ``users.dat``; load ``ratings.dat`` if real,
    else synthesize ``synthetic_ratings`` rows (default
    ``DataConfig.synthetic_num_ratings``, 1,000,209)."""
    movies = read_dat(os.path.join(data_dir, "movies.dat"), MOVIE_COLUMNS)
    users = read_dat(os.path.join(data_dir, "users.dat"), USER_COLUMNS)
    ratings_path = os.path.join(data_dir, "ratings.dat")
    real = (os.path.exists(ratings_path)
            and os.path.getsize(ratings_path) > _REAL_RATINGS_BYTES)
    if real:
        from recsys_tpu_torch.utils.native import native_available, parse_ratings_dat

        if native_available():
            cols = parse_ratings_dat(ratings_path)
            ratings = dict(zip(("user_id", "movie_id", "rating", "timestamp"), cols))
        else:
            ratings = read_ratings_dat(ratings_path)
        logger.info("loaded real ratings.dat: %d rows", len(ratings["user_id"]))
    else:
        if synthetic_ratings is None:
            from recsys_tpu_torch.config import DataConfig

            synthetic_ratings = DataConfig().synthetic_num_ratings
        ratings = synthesize_ratings(
            users["user_id"], movies["movie_id"], movies["genres"],
            n_ratings=synthetic_ratings, seed=synthetic_seed,
        )
        logger.info("ratings.dat missing/stripped -> synthesized %d rows",
                    len(ratings["user_id"]))
    return {"ratings": ratings, "movies": movies, "users": users}


AFFINITY_WEIGHT = 3.0
POPULARITY_WEIGHT = 1.0


def latent_preference_model(
    user_ids: np.ndarray,
    movie_ids: np.ndarray,
    movie_genres: np.ndarray,
    seed: int = 1,
    latent_dim: int = 24,
):
    """The generator's ground-truth preference model: returns
    ``(U, V, log_pop, scale, rng, genre_mh)`` such that a user's choice
    logits over the catalog are ``AFFINITY_WEIGHT*scale*(U[u] @ V.T) +
    POPULARITY_WEIGHT*log_pop``; ``rng`` continues the seed's stream."""
    rng = np.random.default_rng(seed)
    n_users, n_items = len(user_ids), len(movie_ids)
    gidx = {g: i for i, g in enumerate(GENRES)}
    genre_mh = np.zeros((n_items, len(GENRES)), np.float32)
    for r, gs in enumerate(movie_genres):
        for g in str(gs).split("|"):
            if g in gidx:
                genre_mh[r, gidx[g]] = 1.0
    genre_mh /= np.maximum(genre_mh.sum(1, keepdims=True), 1.0)

    U = rng.normal(0, 1, (n_users, latent_dim)).astype(np.float32)
    V = rng.normal(0, 1, (n_items, latent_dim)).astype(np.float32)
    G = rng.normal(0, 1, (len(GENRES), latent_dim)).astype(np.float32)
    V = 0.7 * V + 0.9 * (genre_mh @ G)  # genre-structured item factors
    pop = rng.lognormal(0.0, 1.1, n_items).astype(np.float32)
    return U, V, np.log(pop), 1.0 / np.sqrt(latent_dim), rng, genre_mh


def synthesize_ratings(
    user_ids: np.ndarray,
    movie_ids: np.ndarray,
    movie_genres: np.ndarray,
    n_ratings: int = 1_000_209,
    seed: int = 1,
    latent_dim: int = 24,
) -> Table:
    """Deterministic latent-factor rating generator -> the four int64
    columns of ``ratings.dat``.

    Users and items get latent vectors; items also share genre factors
    and a log-normal popularity bias. Per user: an activity count from a
    power law (min 20, as in ML-1M), items drawn without replacement by
    Gumbel top-k on affinity + popularity, ratings from the standardized
    affinity plus noise, timestamps increasing per user inside the ML-1M
    window (2000-04 .. 2003-02). Without-replacement draws make an
    unfiltered oracle near-random: evaluate with ``filter_seen``.
    """
    U, V, log_pop, lat_scale, rng, _ = latent_preference_model(
        user_ids, movie_ids, movie_genres, seed, latent_dim
    )
    n_users, n_items = len(user_ids), len(movie_ids)

    # power-law activity, min 20, scaled to ~n_ratings total
    act = np.maximum(rng.pareto(1.3, n_users) * 25, 20.0)
    act = (act / act.sum() * n_ratings).astype(np.int64)
    act = np.clip(act, min(20, n_items), n_items)

    t0, t1 = 956_703_932, 1_046_454_590  # ML-1M timestamp window
    user_start = rng.integers(t0, t1 - 40_000_000, n_users)

    rows_u, rows_m, rows_r, rows_t = [], [], [], []
    for u0 in range(0, n_users, 512):
        u1 = min(u0 + 512, n_users)
        aff = (U[u0:u1] @ V.T) * lat_scale  # [b, n_items]
        logits = AFFINITY_WEIGHT * aff + POPULARITY_WEIGHT * log_pop[None, :]
        gumbel = rng.gumbel(0, 1, logits.shape).astype(np.float32)
        order = np.argsort(-(logits + gumbel), axis=1)
        for i in range(u1 - u0):
            n_u = act[u0 + i]
            picked = order[i, :n_u]
            a = aff[i, picked]
            r = np.clip(np.round(3.55 + 0.85 * a + rng.normal(0, 0.9, n_u)), 1, 5)
            ts = np.sort(
                user_start[u0 + i]
                + rng.exponential(3e5, n_u).cumsum().astype(np.int64)
            )
            rows_u.append(np.full(n_u, user_ids[u0 + i], np.int64))
            rows_m.append(movie_ids[picked])
            rows_r.append(r.astype(np.int64))
            rows_t.append(np.minimum(ts, t1))

    out = {
        "user_id": np.concatenate(rows_u),
        "movie_id": np.concatenate(rows_m).astype(np.int64),
        "rating": np.concatenate(rows_r),
        "timestamp": np.concatenate(rows_t).astype(np.int64),
    }
    logger.info("synthetic ratings: %d rows, %.1f%% positive(>=4)",
                len(out["rating"]), 100.0 * (out["rating"] >= 4).mean())
    return out
