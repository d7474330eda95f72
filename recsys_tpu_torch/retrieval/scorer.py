"""On-device scoring and top-k over the materialized catalog (the
counterpart of ``recsys_tpu/retrieval/scorer.py``).

``/recommend`` scores are cosine (both sides L2-normalized) and
``score()`` exposes the raw dot product, as in the JAX package.

Exact search (:func:`exact_topk`) differs from the JAX package in one
place: there, the dense product serves every k while the [Q, N] scores
fit under ``_DENSE_SCORES_CAP`` and the flash kernel serves k <= 128
above it only on a TPU. Here the flash top-k kernel serves every
``k <= 256``; larger k take the dense :func:`topk_scores` under the cap
and the exact blockwise scan above it, as in the JAX package. The cap
bounds memory, not speed; its 1 GiB is the TPU's value, unmeasured on
the H100.

``RetrievalIndex.search(approx=True)`` runs the group-max sieve
(:func:`recsys_tpu_torch.ops.topk_flash.blockmax_topk`, bf16 operands,
fp32 sums): the TPU's ``lax.approx_max_k`` has no Hopper counterpart.

:class:`ShardedIndex` (``RetrievalIndex.shard``) row-shards the catalog
over the ``model`` axis of a mesh, one rank a shard; its search
(:func:`make_sharded_topk`) scores each shard with :func:`exact_topk`
where the JAX package forms the dense [Q, rows] scores: the same answer
without the score matrix.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops.topk import blockwise_topk, blockwise_topk_int8, quantize_rows
from recsys_tpu_torch.ops.topk_flash import (
    KBUF_MAX, _prepare, blockmax_topk, flash_topk, l2_normalize,
)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "l2_normalize", "materialize_item_embeddings", "topk_scores",
    "exact_topk", "make_sharded_topk", "RetrievalIndex", "ShardedIndex",
]


@torch.inference_mode()
def materialize_item_embeddings(tower_params, cfg: ModelConfig, n_items: int,
                                batch: int = 1024) -> torch.Tensor:
    """All item embeddings [n_items, d] through the item tower, in
    batches of ``batch`` ids, on the device the params live on."""
    device = tower_params["item_table"].device
    ids = torch.arange(n_items, device=device)
    return torch.cat([TwoTower.item_embed(tower_params, ids[i:i + batch], cfg)
                      for i in range(0, n_items, batch)])


def topk_scores(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                normalize: bool = True,
                item_bias: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scoring + top-k: ``torch.matmul`` + ``torch.topk``, the path
    for k > 256 (k <= N). -> (scores [Q, k], ids [Q, k] int64)."""
    topk_scores.calls += 1
    if normalize:
        user_emb, item_emb = l2_normalize(user_emb), l2_normalize(item_emb)
    scores = torch.matmul(user_emb, item_emb.T)
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    return torch.topk(scores, k, dim=1)


topk_scores.calls = 0


# above this many bytes of dense [Q, N] fp32 scores, exact top-k with
# k > 256 switches from the dense product to the blockwise scan, which
# never forms them. The TPU's value (recsys_tpu/retrieval/scorer.py);
# a memory bound, unmeasured on H100.
_DENSE_SCORES_CAP = 1 << 30
# items per block of that scan, as in the JAX package
_EXACT_BLOCK = 262144


def exact_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
               normalize: bool = True,
               item_bias: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: the flash running top-k for k <= 256; above, the dense
    product while Q * N * 4 bytes fit under ``_DENSE_SCORES_CAP``, else the
    blockwise scan (the bias folded in as ``[u|1] . [v|b]``). No branch
    forms [Q, N] above the cap."""
    if k <= KBUF_MAX:
        return flash_topk(user_emb, item_emb, k, normalize=normalize,
                          item_bias=item_bias)
    if user_emb.shape[0] * item_emb.shape[0] * 4 <= _DENSE_SCORES_CAP:
        return topk_scores(user_emb, item_emb, k, normalize, item_bias)
    u, v = _prepare(user_emb, item_emb, normalize, item_bias)
    return blockwise_topk(u, v, k, block_size=_EXACT_BLOCK, normalize=False)


def make_sharded_topk(ctx, k: int, normalize: bool = True, masked: bool = False,
                      int8: bool = False) -> Callable:
    """Sharded scorer over ``ctx`` (a
    :class:`~recsys_tpu_torch.parallel.mesh.MeshContext`): items
    row-sharded over ``model``, queries split over ``data``; the top-k of
    each shard, then the merge across shards
    (``collectives.merge_topk``), then the ``data`` slices gathered.

    Returns ``f(user_emb [Q, d], item_shard [rows, d]) -> (scores [Q, k],
    global ids [Q, k])`` on every rank: ``user_emb`` is the same on every
    rank (Q a multiple of ``n_data``), ``item_shard`` this rank's rows.
    The scores are :func:`exact_topk`'s (the flash top-k kernel on the
    card for k <= 256), so no [Q, rows] score matrix is formed.

    ``masked=True`` takes an extra ``n_valid``: this rank's real rows, at
    the head of its shard, before the pad rows that make the catalog a
    multiple of ``n_model``. Pad rows are never scored; where a shard has
    fewer real rows than its candidates, the rest score ``-inf`` with the
    pad rows' ids, as the JAX package's mask gives them.

    ``int8=True`` (requires ``masked``) scores int8 shards: the arguments
    become ``(user_emb, q_shard int8 [rows, d], scale_shard [rows],
    n_valid)``. Quantize the normalized rows when cosine is wanted; the
    queries are quantized per call (:func:`blockwise_topk_int8`: exact
    products of the int8 values and the two scales, no fp32 refine)."""
    from recsys_tpu_torch.parallel.collectives import gather_rows, merge_topk

    if int8 and not masked:
        raise ValueError("int8 sharded top-k requires masked=True")

    def local_merge(u, topk_rows, rows: int, n_valid: int):
        """This rank's data slice of ``u`` -> its merged top k."""
        kk, real = min(k, rows), min(k, rows, n_valid)
        if real:
            s, i = topk_rows(u, real)
        else:
            s = u.new_empty((u.shape[0], 0))
            i = torch.empty((u.shape[0], 0), dtype=torch.long, device=u.device)
        if real < kk:  # pad rows: -inf with their own ids, as under the mask
            pad = kk - real
            s = torch.cat([s, s.new_full((u.shape[0], pad), float("-inf"))], dim=1)
            ids = torch.arange(n_valid, n_valid + pad, device=u.device)
            i = torch.cat([i, ids.expand(u.shape[0], pad)], dim=1)
        return merge_topk(ctx, s, i + ctx.model_index * rows, k, axis=ctx.model_axis)

    def data_slice(user_emb):
        local = ctx.local_batch(user_emb.shape[0])
        return user_emb[ctx.data_index * local:(ctx.data_index + 1) * local].float()

    def gather(s, i):
        return (gather_rows(ctx, s, ctx.data_axis), gather_rows(ctx, i, ctx.data_axis))

    if int8:
        def sharded(user_emb, q_shard, scale_shard, n_valid: int):
            u = data_slice(user_emb)
            if normalize:
                u = l2_normalize(u)
            return gather(*local_merge(
                u, lambda u, kk: blockwise_topk_int8(u, q_shard[:n_valid],
                                                     scale_shard[:n_valid], kk),
                q_shard.shape[0], n_valid))
        return sharded

    def sharded(user_emb, item_shard, n_valid=None):
        u = data_slice(user_emb)
        v = item_shard.float()
        if normalize:
            u, v = l2_normalize(u), l2_normalize(v)
        rows = v.shape[0]
        n_valid = rows if n_valid is None else n_valid
        return gather(*local_merge(
            u, lambda u, kk: exact_topk(u, v[:n_valid], kk, normalize=False),
            rows, n_valid))

    if masked:
        return sharded
    return lambda user_emb, item_shard: sharded(user_emb, item_shard)


class RetrievalIndex:
    """Materialized item-embedding catalog + raw-id map, one npz
    artifact. The host copy is canonical; the device copy (and, under
    cosine, its normalized form, and the bf16 and int8 catalogs a search
    mode asks for) is made once, so each query is one normalization of
    the query and one top-k call."""

    def __init__(self, item_embeddings: np.ndarray, item_raw_ids: np.ndarray,
                 normalize: bool = True, device: DeviceLike = "cuda"):
        self.item_embeddings_np = np.asarray(item_embeddings, np.float32)
        self.item_raw_ids = np.asarray(item_raw_ids)
        self.normalize = normalize
        self.device = resolve_device(device)
        self._device_embs: Optional[torch.Tensor] = None
        self._device_embs_norm: Optional[torch.Tensor] = None
        self._device_embs_bf16: Optional[torch.Tensor] = None
        self._int8: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def item_embeddings(self) -> torch.Tensor:
        if self._device_embs is None:
            self._device_embs = torch.from_numpy(self.item_embeddings_np).to(self.device)
        return self._device_embs

    def _catalog_ready(self) -> torch.Tensor:
        """Device catalog with the cosine normalization applied once."""
        if not self.normalize:
            return self.item_embeddings
        if self._device_embs_norm is None:
            self._device_embs_norm = l2_normalize(self.item_embeddings)
        return self._device_embs_norm

    def _query_ready(self, user_emb) -> torch.Tensor:
        u = torch.as_tensor(user_emb, dtype=torch.float32, device=self.device)
        return l2_normalize(u) if self.normalize else u

    @classmethod
    def build(cls, tower_params, cfg: ModelConfig, n_items: int,
              item_raw_ids: np.ndarray, normalize: bool = True,
              device: DeviceLike = "cuda") -> "RetrievalIndex":
        """Materialize the catalog through the item tower on ``device``;
        the tower params must already lie there (nothing moves them)."""
        dev = resolve_device(device)
        if tower_params["item_table"].device != dev:
            raise ValueError(
                f"RetrievalIndex.build on {dev}, but the tower params lie on "
                f"{tower_params['item_table'].device}")
        embs = materialize_item_embeddings(tower_params, cfg, n_items)
        return cls(embs.cpu().numpy(), item_raw_ids, normalize, dev)

    def _catalog_bf16(self) -> torch.Tensor:
        """The ready catalog rounded to bf16, made once (the sieve's operand)."""
        if self._device_embs_bf16 is None:
            self._device_embs_bf16 = self._catalog_ready().to(torch.bfloat16)
        return self._device_embs_bf16

    def _catalog_int8(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ready catalog quantized per row (after normalization), made once."""
        if self._int8 is None:
            self._int8 = quantize_rows(self._catalog_ready())
        return self._int8

    @torch.inference_mode()
    def search(self, user_emb, k: int, approx: bool = False,
               block_size: int = 0, int8: bool = False,
               refine_factor: int = 1, flash: bool = False,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], dense item ids [Q, k]).

        * ``int8=True``: blockwise top-k over the int8 catalog (blocks of
          ``block_size or 65536``); with ``refine_factor > 1`` the top
          ``k * refine_factor`` (at most the catalog) are rescored exactly
          in fp32 and the top k kept;
        * ``flash=True``: the flash top-k kernel (k <= 256) over
          bf16-rounded operands, as the JAX package's default;
        * ``approx=True``: the group-max sieve over the bf16 catalog
          (:func:`blockmax_topk`), where the JAX package runs the TPU's
          ``approx_max_k``;
        * ``block_size`` alone: the exact blockwise scan;
        * otherwise :func:`exact_topk`."""
        u = self._query_ready(user_emb)
        if int8:
            n = self.item_embeddings_np.shape[0]
            # past the catalog the scan pads with clipped ids, whose
            # placeholder scores the refine would replace with real ones,
            # surfacing duplicate items
            k1 = max(k, min(k * max(int(refine_factor), 1), n))
            item_q, item_scale = self._catalog_int8()
            s, i = blockwise_topk_int8(u, item_q, item_scale, k1,
                                       block_size=block_size or 65536, approx=approx)
            if refine_factor > 1:
                exact = torch.matmul(self._catalog_ready()[i], u[:, :, None])[..., 0]
                s, pos = torch.topk(exact, k, dim=1)
                i = torch.gather(i, 1, pos)
        elif flash:
            # the JAX call's default bf16=True: bf16-rounded operands, whose
            # products the fp32 kernel computes exactly
            s, i = flash_topk(u.to(torch.bfloat16).float(), self._catalog_bf16().float(),
                              k, normalize=False)
        elif approx:
            s, i = blockmax_topk(u, self._catalog_bf16(), k, normalize=False, bf16=True)
        elif block_size:
            s, i = blockwise_topk(u, self._catalog_ready(), k, block_size=block_size,
                                  normalize=False)
        else:
            s, i = exact_topk(u, self._catalog_ready(), k, normalize=False)
        return s.cpu().numpy(), i.cpu().numpy()

    @torch.inference_mode()
    def raw_dot_scores(self, user_emb, item_ids: np.ndarray) -> np.ndarray:
        """Un-normalized dot for the /score contract."""
        u = torch.as_tensor(user_emb, dtype=torch.float32, device=self.device)
        sel = self.item_embeddings[torch.as_tensor(item_ids, device=self.device).long()]
        return torch.matmul(u, sel.T).cpu().numpy()

    def shard(self, ctx, int8: bool = False) -> "ShardedIndex":
        """This catalog row-sharded over ``ctx``'s ``model`` axis (int8
        quantized: 4x the rows a card)."""
        return ShardedIndex(self, ctx, int8=int8)

    def save(self, path: str) -> None:
        """The JAX package's npz keys, uncompressed: fp32 embeddings shrink
        by ~7% under zlib, which takes tens of seconds at 1M items."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path,
            item_embeddings=self.item_embeddings_np,
            item_raw_ids=self.item_raw_ids,
            normalize=np.array(self.normalize),
        )

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "RetrievalIndex":
        with np.load(path) as z:
            return cls(z["item_embeddings"], z["item_raw_ids"],
                       bool(z["normalize"]), device)


class ShardedIndex:
    """A :class:`RetrievalIndex` row-sharded over the ``model`` axis of a
    mesh: each rank holds ``ceil(n_items / n_model)`` rows on its device
    and nothing else of the catalog; a search is each shard's exact top-k
    and a merge across ranks (k * n_model values a query). A catalog
    larger than one card's memory serves from as many cards as it takes.

    Rows are zero-padded to a shard multiple at the end of the catalog,
    and pad rows never surface. Queries are padded to a ``data``-axis
    multiple and trimmed on return. Under cosine the shard is normalized
    once, here, and each query per call.

    ``int8=True`` stores the shard int8-quantized (per row, symmetric,
    after the normalization when cosine) with its fp32 scales: both
    catalog-scaling axes compose, ``n_model`` shards x 4x rows a card.
    """

    def __init__(self, index: RetrievalIndex, ctx, int8: bool = False):
        self.ctx = ctx
        self.item_raw_ids = index.item_raw_ids
        self.normalize = index.normalize
        self.int8 = int8
        embs = index.item_embeddings_np
        n, d = embs.shape
        self.n_items = n
        self.rows = -(-n // ctx.n_model)
        lo = min(n, ctx.model_index * self.rows)
        hi = min(n, lo + self.rows)
        self.n_valid = hi - lo
        host = np.zeros((self.rows, d), np.float32)
        host[:self.n_valid] = embs[lo:hi]
        self.item_q = self.item_scale = self.item_embeddings = None
        if int8:
            # on the host, as the JAX package quantizes its padded catalog
            if self.normalize:
                host = host / np.maximum(np.linalg.norm(host, axis=-1, keepdims=True), 1e-12)
            absmax = np.maximum(np.max(np.abs(host), axis=-1), 1e-12)
            scale = (absmax / 127.0).astype(np.float32)
            q = np.clip(np.round(host / scale[:, None]), -127, 127).astype(np.int8)
            self.item_q = torch.from_numpy(q).to(ctx.device)
            self.item_scale = torch.from_numpy(scale).to(ctx.device)
        else:
            shard = torch.from_numpy(host).to(ctx.device)
            self.item_embeddings = l2_normalize(shard) if self.normalize else shard
        self._fns: Dict[int, Callable] = {}

    @torch.inference_mode()
    def search(self, user_emb, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``user_emb`` [Q, d], the same on every rank -> (scores [Q, k],
        dense item ids [Q, k]) on every rank, ids < ``n_items``."""
        u = torch.as_tensor(user_emb, dtype=torch.float32, device=self.ctx.device)
        q = u.shape[0]
        q_pad = -(-q // self.ctx.n_data) * self.ctx.n_data
        if q_pad != q:
            u = torch.cat([u, u.new_zeros((q_pad - q, u.shape[1]))])
        if self.normalize:
            u = l2_normalize(u)
        fn = self._fns.get(k)
        if fn is None:  # the shard is normalized already
            fn = self._fns[k] = make_sharded_topk(self.ctx, k, normalize=False,
                                                  masked=True, int8=self.int8)
        if self.int8:
            s, i = fn(u, self.item_q, self.item_scale, self.n_valid)
        else:
            s, i = fn(u, self.item_embeddings, self.n_valid)
        return s[:q].cpu().numpy(), i[:q].cpu().numpy()
