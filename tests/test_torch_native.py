"""The port's own binding to ``native/native.cpp``
(``recsys_tpu_torch/utils/native.py``) against the JAX package's binding,
on the CPU: ``parse_ratings_dat``, ``topk_dot`` and ``gather_batch`` give
the JAX binding's results (bit for bit where the arithmetic is the same;
top-k scores to 1e-6 relative), the numpy fallbacks give the library's,
and the data layer's native routes (the ``Batcher``'s gather, a real
``ratings.dat``) give the same bundles as the numpy routes and the JAX
package. The port builds its library under ``build/native`` and leaves
``native/`` (the JAX package's ``libnative.so``) byte for byte as it was.
"""

import hashlib
import os

import numpy as np
import pytest

from recsys_tpu.data import movielens as jax_ml
from recsys_tpu.data.pipeline import Batcher as JaxBatcher
from recsys_tpu.utils import native as jax_native
from recsys_tpu_torch.data import movielens
from recsys_tpu_torch.data.pipeline import Batcher
from recsys_tpu_torch.data.preprocessing import preprocessing_pipeline
from recsys_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")


def _native_dir_digest() -> dict:
    out = {}
    for name in sorted(os.listdir(NATIVE_DIR)):
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def no_library(monkeypatch):
    """The binding as on a machine without a compiler: numpy fallbacks."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", True)


def test_builds_its_own_library_and_leaves_native_untouched(tmp_path, monkeypatch):
    before = _native_dir_digest()
    assert native.native_available()
    assert native.library_path().parent == native.BUILD_DIR
    assert str(native.BUILD_DIR).startswith(os.path.join(REPO, "build"))
    # a fresh build from the source, as on a machine that has none yet
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    lib = native.build()
    assert lib.parent == tmp_path / "native" and lib.exists()
    assert native.build() == lib  # keyed on the source: built once
    assert os.listdir(tmp_path / "native") == [lib.name]
    assert _native_dir_digest() == before


def _write_ratings(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("case", ["integers", "fractional", "malformed"])
def test_parse_ratings_dat_matches_jax(tmp_path, case):
    lines = {"integers": ["1::1193::5::978300760", "1::661::3::978302109",
                          "2::110::4::978301968"],
             "fractional": ["1::1193::5::978300760", "2::110::4.5::978301968",
                            "3::7::0.5::1"],
             "malformed": ["1::2::3::4", "garbage line", "", "5::6::7::8",
                           "9::10::x::11", "12::13::14::15"]}[case]
    p = _write_ratings(tmp_path / "ratings.dat", lines)
    got, want = native.parse_ratings_dat(p), jax_native.parse_ratings_dat(p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case == "malformed":
        np.testing.assert_array_equal(got[0], [1, 5, 12])


def test_parse_ratings_dat_large_and_fallback(tmp_path, no_library):
    rng = np.random.default_rng(0)
    n = 20_000
    cols = (rng.integers(1, 6041, n), rng.integers(1, 3953, n), rng.integers(1, 6, n),
            rng.integers(900_000_000, 1_000_000_000, n))
    p = _write_ratings(tmp_path / "big.dat", [f"{u}::{m}::{r}::{t}" for u, m, r, t in zip(*cols)])
    fallback = native.parse_ratings_dat(p)  # numpy: the library is forced away
    want = jax_native.parse_ratings_dat(p)
    for f, w, c in zip(fallback, want, cols):
        assert f.dtype == w.dtype
        np.testing.assert_array_equal(f, w)
        np.testing.assert_array_equal(f, c)


def test_parse_ratings_dat_library_on_large_file(tmp_path):
    rng = np.random.default_rng(1)
    n = 20_000
    cols = (rng.integers(1, 6041, n), rng.integers(1, 3953, n), rng.integers(1, 6, n),
            rng.integers(900_000_000, 1_000_000_000, n))
    p = _write_ratings(tmp_path / "big.dat", [f"{u}::{m}::{r}::{t}" for u, m, r, t in zip(*cols)])
    for got, want, c in zip(native.parse_ratings_dat(p), jax_native.parse_ratings_dat(p), cols):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, c)


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_topk_dot_matches_jax(request, fallback, bias):
    if fallback:
        request.getfixturevalue("no_library")
    rng = np.random.default_rng(2)
    q = rng.normal(size=(7, 32)).astype(np.float32)
    items = rng.normal(size=(500, 32)).astype(np.float32)
    b = rng.normal(size=500).astype(np.float32) * 5 if bias else None
    s, i = native.topk_dot(q, items, 9, bias=b)
    js, ji = jax_native.topk_dot(q, items, 9, bias=b)
    assert s.dtype == js.dtype == np.float32 and i.dtype == ji.dtype == np.int32
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-6, atol=1e-6)
    dense = q @ items.T + (0 if b is None else b[None, :])
    np.testing.assert_array_equal(i, np.argsort(-dense, axis=1)[:, :9])


def test_topk_dot_k_beyond_catalog():
    q = np.ones((2, 4), np.float32)
    items = np.eye(4, dtype=np.float32)[:3]
    s, i = native.topk_dot(q, items, 10)
    js, ji = jax_native.topk_dot(q, items, 10)
    assert s.shape == i.shape == js.shape == (2, 3)
    np.testing.assert_array_equal(s, js)


def _columns(n, rng):
    return {"i32": rng.integers(0, 99, n).astype(np.int32),
            "i64": rng.integers(0, 99, n).astype(np.int64),
            "f32": rng.normal(size=n).astype(np.float32),
            "f64": rng.normal(size=n),
            "wide": rng.normal(size=(n, 29)).astype(np.float32)}


@pytest.mark.parametrize("fallback", [False, True])
def test_gather_batch_matches_jax_and_numpy(request, fallback):
    if fallback:
        request.getfixturevalue("no_library")
    rng = np.random.default_rng(3)
    n = 5000
    cols = _columns(n, rng)
    idx = np.concatenate([rng.integers(0, n, 500), [0, 0, n - 1, n - 1, 7, 7]])
    got, want = native.gather_batch(cols, idx), jax_native.gather_batch(cols, idx)
    assert list(got) == list(cols)
    for k, v in cols.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v[idx])
        np.testing.assert_array_equal(got[k], want[k])


def test_gather_batch_rejects_out_of_range():
    cols = {"a": np.arange(10, dtype=np.float32)}
    for bad in ([0, 10], [-1, 3]):
        with pytest.raises(ValueError, match="out of range"):
            native.gather_batch(cols, np.array(bad))


def test_batcher_native_gather_is_bit_equal(tiny_bundle, monkeypatch):
    """The Batcher's epochs through the native gather, through numpy, and
    the JAX Batcher's (its own native gather), equal bit for bit."""
    def epochs(cls, **kw):
        return [list(cls(tiny_bundle, "train", 256, seed=9, **kw).epoch(e)) for e in (0, 1)]

    with_native = epochs(Batcher)
    want = epochs(JaxBatcher)
    eval_native = list(Batcher(tiny_bundle, "val", 256, shuffle=False,
                               drop_remainder=False).epoch(0))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", True)
    without = epochs(Batcher)
    eval_numpy = list(Batcher(tiny_bundle, "val", 256, shuffle=False,
                              drop_remainder=False).epoch(0))
    for a_ep, b_ep, c_ep in zip(with_native, without, want):
        assert len(a_ep) == len(b_ep) == len(c_ep) > 0
        for a, b, c in zip(a_ep, b_ep, c_ep):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == c[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k])
    for a, b in zip(eval_native, eval_numpy):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _raw_dir(d, n_ratings, rng, junk=()):
    """movies.dat, users.dat and a real (over 1 MB) ratings.dat with the
    ``junk`` lines among the rows."""
    with open(os.path.join(d, "movies.dat"), "w", encoding="latin-1") as f:
        f.write("\n".join(f"{m}::Movie {m} (1990)::Drama|Action" for m in range(1, 121)) + "\n")
    with open(os.path.join(d, "users.dat"), "w", encoding="latin-1") as f:
        f.write("\n".join(f"{u}::M::25::4::12345" for u in range(1, 81)) + "\n")
    lines = [f"{u}::{m}::{r}::{t}" for u, m, r, t in zip(
        rng.integers(1, 81, n_ratings), rng.integers(1, 121, n_ratings),
        rng.integers(1, 6, n_ratings), rng.integers(956_703_932, 1_046_454_590, n_ratings))]
    for j, line in enumerate(junk):
        lines.insert(1000 * (j + 1), line)
    with open(os.path.join(d, "ratings.dat"), "w") as f:
        f.write("\n".join(lines) + "\n")
    assert os.path.getsize(os.path.join(d, "ratings.dat")) > movielens._REAL_RATINGS_BYTES


def test_real_ratings_through_the_native_parser(tmp_path, monkeypatch):
    """A real ratings.dat with malformed lines: the port's native route
    skips them as the JAX package's native parser does, and gives the
    JAX package's rows; on clean files the preprocessed bundles of the
    native and the numpy routes are equal bit for bit."""
    rng = np.random.default_rng(5)
    dirty, clean = tmp_path / "dirty", tmp_path / "clean"
    dirty.mkdir()
    clean.mkdir()
    _raw_dir(str(dirty), 60_000, rng, junk=("not a rating", "1::2::3", "4::x::5::6"))
    _raw_dir(str(clean), 60_000, np.random.default_rng(6))
    got = movielens.load_movielens_data(str(dirty))["ratings"]
    want = jax_ml.load_movielens_data(str(dirty))["ratings"]
    assert len(got["user_id"]) == 60_000
    for c in ("user_id", "movie_id", "rating", "timestamp"):
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)

    def bundle():
        raw = movielens.load_movielens_data(str(clean))
        return preprocessing_pipeline(raw["ratings"], raw["movies"], raw["users"])

    with_native = bundle()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", True)
    with_numpy = bundle()
    assert with_native.keys() == with_numpy.keys()
    for k in with_native:
        assert with_native[k].dtype == with_numpy[k].dtype, k
        np.testing.assert_array_equal(with_native[k], with_numpy[k], err_msg=k)
