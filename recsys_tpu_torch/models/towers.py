"""Two-tower encoder: embedding-row gather + per-tower MLP with the
residual, in inference and train mode (the counterpart of
``recsys_tpu/models/towers.py``).

Tables carry one extra out-of-vocabulary row at index ``n``; lookups
clip ids to ``[0, n]``, so an unknown id reads the OOV row. Padded to a
row-sharded ``model`` axis (``rows_multiple``), the clip is to the last
row, a pad row, as in the JAX package's code (its docstring says the OOV
row). A ``lookup`` (the row-sharded tables' collective lookups,
``embed/table.py``) replaces the gather.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.embed.table import lookup_replicated
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device


class TwoTower:
    """Namespace of functions over a nested dict of tensors
    (init / user_embed / item_embed / apply)."""

    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig, n_users: int,
             n_items: int, device: DeviceLike = "cuda", rows_multiple: int = 1) -> Dict:
        """Random params from ``generator`` (drawn on the CPU, then placed
        on ``device``); raises if ``device`` is the card and there is none.
        ``rows_multiple`` pads the row counts (the OOV row included) up to a
        multiple, so the tables and ``item_bias`` split evenly over a
        row-sharded ``model`` axis. The pad rows are zeros and draw nothing
        from ``generator``: a padded init equals the unpadded one on every
        real row and every other leaf (the JAX package draws its pad rows,
        from other keys than the port's anyway)."""
        device = resolve_device(device)
        d = cfg.embedding_dim
        scale = d ** -0.5

        def rows(n):  # +1 OOV row, then the padding
            return -(-(n + 1) // rows_multiple) * rows_multiple

        def table(n):
            drawn = torch.randn((n + 1, d), generator=generator) * scale
            pad = torch.zeros((rows(n) - n - 1, d))
            return torch.cat([drawn, pad]).to(device)

        return {
            "user_table": table(n_users),
            "item_table": table(n_items),
            "user_tower": L.init_mlp(generator, [d, *cfg.user_tower_dims, d], device),
            "item_tower": L.init_mlp(generator, [d, *cfg.item_tower_dims, d], device),
            "item_bias": torch.zeros((rows(n_items),), dtype=torch.float32,
                                     device=device),
        }

    @staticmethod
    def _tower(table: torch.Tensor, tower_params: Dict, ids: torch.Tensor,
               cfg: ModelConfig, train: bool = False,
               generator: Optional[torch.Generator] = None, lookup=None) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=table.device).long()
        # ``lookup(table, ids [N]) -> rows [N, d]``, an [B, K] id array
        # (explicit negatives) flattened through it; by default the dense
        # gather, whose gradient is a scatter-add into the whole table, as
        # in the JAX package
        lookup = lookup or lookup_replicated
        rows = lookup(table, ids.reshape(-1)).reshape(ids.shape + (table.shape[-1],))
        out = L.mlp(tower_params, rows, activation=torch.relu,
                    final_activation=None, bf16=cfg.mixed_precision,
                    dropout_rate=cfg.dropout_rate, train=train, generator=generator)
        if cfg.tower_residual:
            out = out + rows  # both fp32, as in the JAX package
        return out

    @staticmethod
    def user_embed(params: Dict, user_ids, cfg: ModelConfig, train: bool = False,
                   generator: Optional[torch.Generator] = None, lookup=None) -> torch.Tensor:
        return TwoTower._tower(params["user_table"], params["user_tower"],
                               user_ids, cfg, train, generator, lookup)

    @staticmethod
    def item_embed(params: Dict, item_ids, cfg: ModelConfig, train: bool = False,
                   generator: Optional[torch.Generator] = None, lookup=None) -> torch.Tensor:
        return TwoTower._tower(params["item_table"], params["item_tower"],
                               item_ids, cfg, train, generator, lookup)

    @staticmethod
    def apply(params: Dict, cfg: ModelConfig, user_ids=None, item_ids=None,
              train: bool = False, generator: Optional[torch.Generator] = None,
              lookup=None) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Partial-input contract: (user_emb | None, item_emb | None) for
        whichever ids were given. In train mode the tower MLPs apply
        dropout, drawn from ``generator`` (user tower first)."""
        u = (TwoTower.user_embed(params, user_ids, cfg, train, generator, lookup)
             if user_ids is not None else None)
        v = (TwoTower.item_embed(params, item_ids, cfg, train, generator, lookup)
             if item_ids is not None else None)
        return u, v
