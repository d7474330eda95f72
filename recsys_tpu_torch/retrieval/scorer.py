"""Exact scoring + top-k over the materialized catalog (the counterpart
of ``recsys_tpu/retrieval/scorer.py``).

``/recommend`` scores are cosine (both sides L2-normalized) and
``score()`` exposes the raw dot product, as in the JAX package.

Dispatch differs from the JAX package: there, exact search reaches the
flash top-k kernel only on a TPU and above ``_DENSE_SCORES_CAP`` (1 GiB
of scores). Here every exact search with ``k <= 256`` goes through
:func:`recsys_tpu_torch.ops.topk_flash.flash_topk` (the CUDA kernel on
the card), and larger k through :func:`topk_scores`. A size cap for the
card is unmeasured on the H100 and not applied.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops.topk_flash import KBUF_MAX, flash_topk, l2_normalize
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


def exact_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
               normalize: bool = True,
               item_bias: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: the flash running top-k for k <= 256, dense above."""
    if k <= KBUF_MAX:
        return flash_topk(user_emb, item_emb, k, normalize=normalize,
                          item_bias=item_bias)
    return topk_scores(user_emb, item_emb, k, normalize, item_bias)


def _not_ported(option: str, item: str):
    raise NotImplementedError(
        f"{option} is not ported to recsys_tpu_torch yet (ROADMAP Queue 1: {item})")


class RetrievalIndex:
    """Materialized item-embedding catalog + raw-id map, one npz
    artifact. The host copy is canonical; the device copy (and, under
    cosine, its normalized form) is made once, so each query is one
    normalization of the query and one top-k call."""

    def __init__(self, item_embeddings: np.ndarray, item_raw_ids: np.ndarray,
                 normalize: bool = True, device: DeviceLike = "cuda"):
        self.item_embeddings_np = np.asarray(item_embeddings, np.float32)
        self.item_raw_ids = np.asarray(item_raw_ids)
        self.normalize = normalize
        self.device = resolve_device(device)
        self._device_embs: Optional[torch.Tensor] = None
        self._device_embs_norm: Optional[torch.Tensor] = None

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

    @torch.inference_mode()
    def search(self, user_emb, k: int, approx: bool = False,
               block_size: int = 0, int8: bool = False,
               refine_factor: int = 1, flash: bool = False,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], dense item ids [Q, k]), exact. The JAX
        package's other search modes are not ported yet and raise."""
        if approx or block_size:
            _not_ported("approximate / blockwise search", "large-catalog retrieval")
        if int8 or refine_factor != 1:
            _not_ported("the int8 catalog", "large-catalog retrieval")
        if flash:
            _not_ported("search(flash=True) (exact search already runs the "
                        "flash kernel)", "large-catalog retrieval")
        s, i = exact_topk(self._query_ready(user_emb), self._catalog_ready(), k,
                          normalize=False)
        return s.cpu().numpy(), i.cpu().numpy()

    @torch.inference_mode()
    def raw_dot_scores(self, user_emb, item_ids: np.ndarray) -> np.ndarray:
        """Un-normalized dot for the /score contract."""
        u = torch.as_tensor(user_emb, dtype=torch.float32, device=self.device)
        sel = self.item_embeddings[torch.as_tensor(item_ids, device=self.device).long()]
        return torch.matmul(u, sel.T).cpu().numpy()

    def shard(self, *args, **kwargs):
        _not_ported("ShardedIndex", "multi-GPU")

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
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
