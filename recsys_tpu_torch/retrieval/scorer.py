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
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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
    "exact_topk", "RetrievalIndex",
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


def _not_ported(option: str, item: str):
    raise NotImplementedError(
        f"{option} is not ported to recsys_tpu_torch yet (ROADMAP Queue 1: {item})")


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

    def shard(self, *args, **kwargs):
        _not_ported("ShardedIndex", "item 8, multi-GPU")

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
