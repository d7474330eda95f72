"""Two-tower encoder: embedding-row gather + per-tower MLP with the
residual, in inference and train mode (the counterpart of
``recsys_tpu/models/towers.py``).

Tables carry one extra out-of-vocabulary row at index ``n``; lookups
clip ids to ``[0, n]``, so an unknown id reads the OOV row.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device


class TwoTower:
    """Namespace of functions over a nested dict of tensors
    (init / user_embed / item_embed / apply)."""

    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig, n_users: int,
             n_items: int, device: DeviceLike = "cuda") -> Dict:
        """Random params from ``generator`` (drawn on the CPU, then placed
        on ``device``); raises if ``device`` is the card and there is none."""
        device = resolve_device(device)
        d = cfg.embedding_dim
        scale = d ** -0.5

        def table(n):  # +1 OOV row
            return (torch.randn((n + 1, d), generator=generator) * scale).to(device)

        return {
            "user_table": table(n_users),
            "item_table": table(n_items),
            "user_tower": L.init_mlp(generator, [d, *cfg.user_tower_dims, d], device),
            "item_tower": L.init_mlp(generator, [d, *cfg.item_tower_dims, d], device),
            "item_bias": torch.zeros((n_items + 1,), dtype=torch.float32,
                                     device=device),
        }

    @staticmethod
    def _tower(table: torch.Tensor, tower_params: Dict, ids: torch.Tensor,
               cfg: ModelConfig, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_oov = table.shape[0] - 1
        ids = torch.as_tensor(ids, device=table.device).long()
        # a dense gather: its gradient is a scatter-add into the whole
        # [n + 1, d] table, as in the JAX package
        rows = table[ids.clamp(0, n_oov)]
        out = L.mlp(tower_params, rows, activation=torch.relu,
                    final_activation=None, bf16=cfg.mixed_precision,
                    dropout_rate=cfg.dropout_rate, train=train, generator=generator)
        if cfg.tower_residual:
            out = out + rows  # both fp32, as in the JAX package
        return out

    @staticmethod
    def user_embed(params: Dict, user_ids, cfg: ModelConfig, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return TwoTower._tower(params["user_table"], params["user_tower"],
                               user_ids, cfg, train, generator)

    @staticmethod
    def item_embed(params: Dict, item_ids, cfg: ModelConfig, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return TwoTower._tower(params["item_table"], params["item_tower"],
                               item_ids, cfg, train, generator)

    @staticmethod
    def apply(params: Dict, cfg: ModelConfig, user_ids=None, item_ids=None,
              train: bool = False, generator: Optional[torch.Generator] = None,
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Partial-input contract: (user_emb | None, item_emb | None) for
        whichever ids were given. In train mode the tower MLPs apply
        dropout, drawn from ``generator`` (user tower first)."""
        u = (TwoTower.user_embed(params, user_ids, cfg, train, generator)
             if user_ids is not None else None)
        v = (TwoTower.item_embed(params, item_ids, cfg, train, generator)
             if item_ids is not None else None)
        return u, v
