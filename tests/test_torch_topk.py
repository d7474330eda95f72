"""Exact top-k of the PyTorch port against the JAX package, on the CPU.

The JAX side runs ``flash_topk`` in interpret mode (its kernel takes
k <= 128) and ``topk_scores`` (every k). Scores must agree to 1e-5
(fp32, summation order only); ids may differ only among equal scores
(ties at the k boundary resolve differently, as the JAX package's own
tests allow).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops.pallas.topk_flash import flash_topk as jax_flash_topk
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.retrieval.scorer import topk_scores as jax_topk_scores
from recsys_tpu_torch.ops import topk_flash
from recsys_tpu_torch.ops.topk_flash import (
    NEG_INF, flash_topk, flash_topk_reference, kbuf_for, plan,
)
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, exact_topk, topk_scores


def _data(q=6, n=301, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _assert_topk_equal(got, want, u, v, normalize=True, bias=None):
    """Scores equal to 1e-5; every returned id really has its score."""
    gs, gi = (np.asarray(t) for t in got)
    ws = np.asarray(want[0])
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
    if normalize:
        u = u / np.linalg.norm(u, axis=1, keepdims=True)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    full = u @ v.T + (0 if bias is None else bias[None, :])
    real = gs > NEG_INF / 2
    picked = np.take_along_axis(full, np.where(real, gi, 0), axis=1)
    np.testing.assert_allclose(picked[real], gs[real], rtol=1e-5, atol=1e-5)
    for row_i, row_real in zip(gi, real):  # no item twice
        assert len(set(row_i[row_real].tolist())) == int(row_real.sum())


@pytest.mark.parametrize("k", [1, 10, 128])
def test_reference_matches_jax_flash_kernel(k):
    u, v = _data()
    want = jax_flash_topk(jnp.asarray(u), jnp.asarray(v), k, bf16=False,
                          block_items=128, q_tile=16, interpret=True)
    got = flash_topk_reference(torch.as_tensor(u), torch.as_tensor(v), k)
    _assert_topk_equal(got, want, u, v)


@pytest.mark.parametrize("k", [1, 10, 128, 200])
def test_exact_topk_matches_jax_topk_scores(k):
    u, v = _data()
    want = jax_topk_scores(jnp.asarray(u), jnp.asarray(v), k)
    got = exact_topk(torch.as_tensor(u), torch.as_tensor(v), k)
    _assert_topk_equal(got, want, u, v)


def test_k_exceeds_catalog_pads_with_neg_inf():
    u, v = _data(n=5, d=8)
    want = jax_flash_topk(jnp.asarray(u), jnp.asarray(v), 10, bf16=False,
                          block_items=128, q_tile=16, interpret=True)
    gs, gi = flash_topk(torch.as_tensor(u), torch.as_tensor(v), 10)
    ws = np.asarray(want[0])
    np.testing.assert_allclose(gs.numpy()[:, :5], ws[:, :5], rtol=1e-5, atol=1e-5)
    assert np.all(gs.numpy()[:, 5:] == np.float32(NEG_INF))
    assert np.all(ws[:, 5:] == np.float32(NEG_INF))
    assert np.all(gi.numpy()[:, 5:] == 0)


def test_item_bias_augmentation_matches_jax():
    u, v = _data(seed=4)
    bias = np.random.default_rng(5).standard_normal(v.shape[0]).astype(np.float32)
    want_kernel = jax_flash_topk(jnp.asarray(u), jnp.asarray(v), 10, bf16=False,
                                 normalize=False, item_bias=jnp.asarray(bias),
                                 block_items=128, q_tile=16, interpret=True)
    want_dense = jax_topk_scores(jnp.asarray(u), jnp.asarray(v), 10,
                                 normalize=False, item_bias=jnp.asarray(bias))
    got = exact_topk(torch.as_tensor(u), torch.as_tensor(v), 10, normalize=False,
                     item_bias=torch.as_tensor(bias))
    _assert_topk_equal(got, want_kernel, u, v, normalize=False, bias=bias)
    _assert_topk_equal(got, want_dense, u, v, normalize=False, bias=bias)
    with pytest.raises(ValueError):
        flash_topk(torch.as_tensor(u), torch.as_tensor(v), 10,
                   item_bias=torch.as_tensor(bias))  # bias needs raw dot


def test_dispatch_and_k_limit():
    u, v = _data(n=400)
    calls = topk_scores.calls
    exact_topk(torch.as_tensor(u), torch.as_tensor(v), 256)
    assert topk_scores.calls == calls  # k <= 256: the flash path
    s, _ = exact_topk(torch.as_tensor(u), torch.as_tensor(v), 300)
    assert topk_scores.calls == calls + 1 and s.shape == (6, 300)
    with pytest.raises(ValueError):
        flash_topk(torch.as_tensor(u), torch.as_tensor(v), 257)
    # CPU tensors never count a kernel launch
    assert topk_flash.flash_topk.launches == 0


@pytest.mark.parametrize("k", [10, 200])
def test_retrieval_index_search_matches_jax(k):
    u, v = _data(q=7, n=333, d=16, seed=9)
    raw = np.arange(333) * 3 + 1
    jidx = JaxRetrievalIndex(v, raw)
    tidx = RetrievalIndex(v, raw, device="cpu")
    _assert_topk_equal(tidx.search(u, k), jidx.search(u, k), u, v)
    np.testing.assert_allclose(tidx.raw_dot_scores(u[:1], np.array([3, 7])),
                               jidx.raw_dot_scores(jnp.asarray(u[:1]), np.array([3, 7])),
                               rtol=1e-5, atol=1e-5)
    # the large-catalog modes agree with the JAX package's too; its flash
    # kernel takes k <= 128, so at k = 200 the port's flash mode (exact over
    # bf16 operands) is held against JAX's bf16 blockwise search, which off
    # the TPU selects exactly over the same operands
    for kw in ({"approx": True}, {"int8": True}, {"flash": True}, {"block_size": 64}):
        jkw = {"approx": True} if "flash" in kw and k > 128 else kw
        ws, wi = (np.asarray(t) for t in jidx.search(u, k, **jkw))
        gs, gi = tidx.search(u, k, **kw)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
        for row_s, row_g, row_w in zip(gs, gi, wi):  # equal ids beyond ties
            clear = row_s > row_s[-1] + 1e-5
            assert set(row_g[clear].tolist()) <= set(row_w.tolist())


@pytest.mark.parametrize("q_n,n,k,n_sm", [
    (1, 3883, 10, 132), (64, 3883, 200, 132), (1, 3883, 200, 132),
    (4096, 1 << 20, 10, 132), (3, 5, 10, 132), (7, 129, 128, 4),
])
def test_kernel_plan_covers_catalog(q_n, n, k, n_sm):
    """What surrounds the CUDA kernel, checked on the CPU: the chunks
    tile the catalog with 64-item tiles, each chunk holds at least one
    buffer's worth of items where the catalog allows, and the buffer
    covers k."""
    kbuf, chunk, n_chunks = plan(q_n, n, k, n_sm)
    assert kbuf == kbuf_for(k) and kbuf >= k and kbuf in (32, 64, 128, 256)
    assert chunk % topk_flash.TB == 0 and chunk * n_chunks >= n
    assert chunk * (n_chunks - 1) < n  # no empty chunk
    assert n_chunks == 1 or chunk >= kbuf
