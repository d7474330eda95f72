"""The port's data layer (numpy only) against the JAX package's (pandas),
on the CPU: ``synthesize_ratings`` draw for draw, the ``.dat`` readers,
``load_movielens_data`` on a real ``ratings.dat``, ``preprocessing_pipeline``
and its QA report, and ``python -m recsys_tpu_torch.preprocess`` against
``scripts/preprocess.py``.

Tolerance: none. Every array of the bundle is ``np.array_equal`` with the
JAX package's, with the same dtype.
"""

import os

import numpy as np
import pandas as pd
import pytest

from recsys_tpu.data import movielens as jax_ml
from recsys_tpu.data import preprocessing as jax_prep
from scripts import preprocess as jax_cli
from recsys_tpu_torch import preprocess as cli
from recsys_tpu_torch.data import movielens, preprocessing

GENRES = movielens.GENRES


def _columns(df: pd.DataFrame) -> dict:
    """A DataFrame as the port's table: a dict of column arrays."""
    return {c: df[c].to_numpy() for c in df.columns}


def _assert_bundles_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _write_raw(d, n_movies=120, n_users=80, missing_user=None, ratings=None):
    """ML-1M-shaped movies.dat and users.dat from a seed: titles with a
    year, some without, one latin-1 title; genres from GENRES. A real
    ``ratings`` table is written as ratings.dat."""
    rng = np.random.default_rng(3)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "movies.dat"), "w", encoding="latin-1") as f:
        for m in range(1, n_movies + 1):
            genres = "|".join(sorted(set(rng.choice(GENRES, rng.integers(1, 4)))))
            title = f"Movie {m}: Part {m % 3} ({1930 + m % 70})"
            if m % 17 == 0:
                title = f"Untitled {m}"  # no year
            if m == 5:
                title = "Amélie (Le Fabuleux destin d'Amélie Poulain) (2001)"
            f.write(f"{m}::{title}::{genres}\n")
    with open(os.path.join(d, "users.dat"), "w", encoding="latin-1") as f:
        for u in range(1, n_users + 1):
            if u == missing_user:
                continue
            age = (1, 18, 25, 35, 45, 50, 56)[u % 7]
            zip_code = f"{10000 + 37 * u}" if u % 5 else f"{10000 + u}-1234"
            f.write(f"{u}::{'MF'[u % 2]}::{age}::{u % 21}::{zip_code}\n")
    if ratings is not None:
        with open(os.path.join(d, "ratings.dat"), "w") as f:
            for row in zip(*(ratings[c] for c in ("user_id", "movie_id", "rating",
                                                  "timestamp"))):
                f.write("::".join(str(int(v)) for v in row) + "\n")


@pytest.mark.parametrize("seed, n_ratings", [(1, 3000), (7, 5000)])
def test_synthesize_ratings_matches_jax(seed, n_ratings):
    """One seed gives the same ratings in both packages: the same draws
    from ``default_rng`` in the same order."""
    rng = np.random.default_rng(seed)
    users = np.arange(1, 61)
    movies = np.arange(1, 151) * 3
    genres = np.array(["|".join(rng.choice(GENRES, 2)) for _ in movies])
    want = jax_ml.synthesize_ratings(users, movies, genres, n_ratings=n_ratings, seed=seed)
    got = movielens.synthesize_ratings(users, movies, genres, n_ratings=n_ratings, seed=seed)
    assert list(got) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
        assert got[c].dtype == np.int64
    jax_model = jax_ml.latent_preference_model(users, movies, genres, seed)
    port_model = movielens.latent_preference_model(users, movies, genres, seed)
    for a, b in zip(port_model[:4] + port_model[5:], jax_model[:4] + jax_model[5:]):
        np.testing.assert_array_equal(a, b)


def test_read_dat_matches_jax(tmp_path):
    """The ``::`` / latin-1 reader gives JAX's ``_read_dat`` columns: equal
    integers, equal text (a latin-1 title, titles with ``:`` in them)."""
    _write_raw(str(tmp_path))
    for name, cols in (("movies.dat", movielens.MOVIE_COLUMNS),
                       ("users.dat", movielens.USER_COLUMNS)):
        path = str(tmp_path / name)
        want = jax_ml._read_dat(path, list(cols))
        got = movielens.read_dat(path, cols)
        assert list(got) == list(want.columns)
        for c in cols:
            if got[c].dtype == np.int64:
                np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
            else:
                assert got[c].tolist() == [str(v) for v in want[c]], c
    titles = movielens.read_dat(str(tmp_path / "movies.dat"), movielens.MOVIE_COLUMNS)["title"]
    assert "Amélie (Le Fabuleux destin d'Amélie Poulain) (2001)" in titles.tolist()


def test_load_movielens_data_real_ratings_matches_jax(tmp_path):
    """Past 1 MB, ratings.dat is real: both packages parse it to the same
    rows (the JAX package through its native parser)."""
    rng = np.random.default_rng(5)
    n = 60_000
    ratings = {"user_id": rng.integers(1, 81, n), "movie_id": rng.integers(1, 121, n),
               "rating": rng.integers(1, 6, n),
               "timestamp": rng.integers(956_703_932, 1_046_454_590, n)}
    _write_raw(str(tmp_path), ratings=ratings)
    assert os.path.getsize(tmp_path / "ratings.dat") > 1_000_000
    want = jax_ml.load_movielens_data(str(tmp_path))
    got = movielens.load_movielens_data(str(tmp_path))
    for c, v in ratings.items():
        np.testing.assert_array_equal(got["ratings"][c], v, err_msg=c)
        np.testing.assert_array_equal(got["ratings"][c], want["ratings"][c].to_numpy())
    assert got["movies"]["movie_id"].tolist() == want["movies"]["movie_id"].tolist()


def _edge_raw(tiny_raw):
    """``tiny_raw`` with the traps of a pandas-free pipeline: timestamps on
    each side of two new years (UTC) and on each weekday at several hours,
    titles without a year, and a user missing from users.dat."""
    ratings = tiny_raw["ratings"].copy()
    ts = ratings["timestamp"].to_numpy().copy()
    year_ends = [978_307_199, 978_307_200, 1_009_843_199, 1_009_843_200]  # 2000/01, 2001/02
    week = [978_307_200 + d * 86_400 + h * 3_600 for d in range(7) for h in (0, 11, 23)]
    edges = np.array(year_ends + week, np.int64)
    ts[:len(edges)] = edges
    ratings["timestamp"] = ts
    movies = tiny_raw["movies"].copy()
    movies.loc[::7, "title"] = [f"No year {i}" for i in range(len(movies.loc[::7]))]
    users = tiny_raw["users"].iloc[1:].reset_index(drop=True)  # user 1 missing
    return ratings, movies, users


@pytest.mark.parametrize("case", ["tiny_raw", "edges"])
def test_preprocessing_pipeline_matches_jax(tiny_raw, case):
    """Every key of the bundle, in order, equal with the same dtype; the
    QA reports equal."""
    if case == "edges":
        ratings, movies, users = _edge_raw(tiny_raw)
    else:
        ratings, movies, users = tiny_raw["ratings"], tiny_raw["movies"], tiny_raw["users"]
    want = jax_prep.preprocessing_pipeline(ratings, movies, users)
    got = preprocessing.preprocessing_pipeline(_columns(ratings), _columns(movies),
                                               _columns(users))
    _assert_bundles_equal(got, want)
    assert preprocessing.check_preprocessing_quality(got) == \
        jax_prep.check_preprocessing_quality(want)
    if case == "edges":
        assert set(got["train/dayofweek"]) | set(got["val/dayofweek"]) \
            | set(got["test/dayofweek"]) == set(range(7))
        assert got["meta/user_gender"][0] == got["meta/user_age"][0] == 0


def test_preprocessing_quality_check_raises(tiny_raw):
    bundle = preprocessing.preprocessing_pipeline(*(_columns(tiny_raw[k]) for k in
                                                    ("ratings", "movies", "users")))
    bad = dict(bundle, **{"val/movie_id": bundle["val/movie_id"] + 10_000})
    with pytest.raises(ValueError, match="val mid out of range"):
        preprocessing.check_preprocessing_quality(bad)


def test_preprocess_cli_matches_the_jax_script(tmp_path, capsys):
    """One argv, the same arrays from both CLIs (ratings synthesized from
    the seed), and the port's bundle loads back unchanged."""
    raw = str(tmp_path / "raw")
    _write_raw(raw)
    args = ["--data_dir", raw, "--synthetic_ratings", "4000", "--synthetic_seed", "3",
            "--implicit_threshold", "3.5"]
    assert jax_cli.main(args + ["--output", str(tmp_path / "jax.npz")]) == 0
    assert cli.main(args + ["--output", str(tmp_path / "port.npz")]) == 0
    report = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"train_rows"' in report
    got = preprocessing.load_bundle(str(tmp_path / "port.npz"))
    want = jax_prep.load_bundle(str(tmp_path / "jax.npz"))
    _assert_bundles_equal(got, want)
    assert float(got["meta/implicit_threshold"]) == 3.5
