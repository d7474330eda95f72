"""Multi-task model: two-tower retrieval + DCN ranking trunk + rating
and CTR heads, inference forward (the counterpart of
``recsys_tpu/models/multitask.py``; ``loss`` comes with the training
slice)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.models.dcn import DeepCrossNetwork
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device


class ForwardOut(NamedTuple):
    user_embedding: torch.Tensor
    item_embedding: torch.Tensor
    rating_pred: torch.Tensor
    ctr_logit: torch.Tensor


class MultiTaskModel:
    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig, n_users: int,
             n_items: int, device: DeviceLike = "cuda") -> Dict:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``), with the JAX package's tree layout. Raises if
        ``device`` is the card and there is none."""
        device = resolve_device(device)
        dcn_in = 2 * cfg.embedding_dim + cfg.dense_features
        dcn_out = DeepCrossNetwork.output_dim(cfg, dcn_in)
        return {
            "towers": TwoTower.init(generator, cfg, n_users, n_items, device),
            "dcn": DeepCrossNetwork.init(generator, cfg, dcn_in, device),
            "rating_head": L.init_dense(generator, dcn_out, 1, device),
            "ctr_head": L.init_dense(generator, dcn_out, 1, device),
        }

    @staticmethod
    def apply(params: Dict, cfg: ModelConfig, user_ids, item_ids,
              dense: Optional[torch.Tensor] = None) -> ForwardOut:
        u, v = TwoTower.apply(params["towers"], cfg, user_ids, item_ids)
        if cfg.dense_features:
            if dense is None:
                raise ValueError(
                    f"model was built with dense_features={cfg.dense_features} "
                    "but no dense batch column was provided")
            x = torch.cat([u, v, dense.to(u.dtype)], dim=-1)
        else:
            x = torch.cat([u, v], dim=-1)
        h = DeepCrossNetwork.apply(params["dcn"], x, cfg)
        rating = L.dense(params["rating_head"], h)[..., 0]
        ctr_logit = L.dense(params["ctr_head"], h)[..., 0]
        return ForwardOut(u, v, rating, ctr_logit)
