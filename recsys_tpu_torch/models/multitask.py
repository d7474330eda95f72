"""Multi-task model: two-tower retrieval + DCN ranking trunk + rating
and CTR heads: the forward (inference and train mode) and the weighted
multi-task loss (the counterpart of ``recsys_tpu/models/multitask.py``).

Gradients come from autograd: ``loss`` is differentiated with
``torch.autograd.grad`` over the param leaves by the trainer, as the JAX
package differentiates it with ``jax.value_and_grad``."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.models import losses
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
             n_items: int, device: DeviceLike = "cuda", rows_multiple: int = 1) -> Dict:
        """Random params from ``generator`` (drawn on the CPU, then moved
        to ``device``), with the JAX package's tree layout; the tables padded
        to ``rows_multiple`` rows (``TwoTower.init``). Raises if ``device``
        is the card and there is none."""
        device = resolve_device(device)
        dcn_in = 2 * cfg.embedding_dim + cfg.dense_features
        dcn_out = DeepCrossNetwork.output_dim(cfg, dcn_in)
        return {
            "towers": TwoTower.init(generator, cfg, n_users, n_items, device, rows_multiple),
            "dcn": DeepCrossNetwork.init(generator, cfg, dcn_in, device),
            "rating_head": L.init_dense(generator, dcn_out, 1, device),
            "ctr_head": L.init_dense(generator, dcn_out, 1, device),
        }

    @staticmethod
    def apply(params: Dict, cfg: ModelConfig, user_ids, item_ids,
              dense: Optional[torch.Tensor] = None, train: bool = False,
              generator: Optional[torch.Generator] = None, lookup=None) -> ForwardOut:
        """In train mode the towers and the deep branch apply dropout,
        drawn from ``generator`` (a generator on the params' device);
        ``lookup`` replaces the towers' table gather."""
        u, v = TwoTower.apply(params["towers"], cfg, user_ids, item_ids, train=train,
                              generator=generator, lookup=lookup)
        if cfg.dense_features:
            if dense is None:
                raise ValueError(
                    f"model was built with dense_features={cfg.dense_features} "
                    "but no dense batch column was provided")
            x = torch.cat([u, v, dense.to(u.dtype)], dim=-1)
        else:
            x = torch.cat([u, v], dim=-1)
        h = DeepCrossNetwork.apply(params["dcn"], x, cfg, train=train, generator=generator)
        rating = L.dense(params["rating_head"], h)[..., 0]
        ctr_logit = L.dense(params["ctr_head"], h)[..., 0]
        return ForwardOut(u, v, rating, ctr_logit)

    @staticmethod
    def loss(
        params: Dict,
        cfg: ModelConfig,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
        class_weights=(1.0, 1.0),
        data_axis: Optional[str] = None,
        global_negatives: bool = False,
        neg_item_ids: Optional[torch.Tensor] = None,
        lookup=None,
        data_axis_size: int = 1,
        extra_candidates=None,
        mesh_ctx=None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Weighted multi-task loss + metric dict, line by line as the JAX
        package's ``MultiTaskModel.loss``: in-batch softmax (logQ, item
        bias, accidental-hit mask, temperature) on the path
        ``losses.resolve_retrieval_loss`` picks for the batch's device,
        MSE on the rating, class-weighted BCE on the CTR logit, and L2 on
        the deep branch and both tower MLPs.

        ``batch`` holds tensors on the params' device: ``user_id``,
        ``movie_id``, ``rating``, ``y_implicit`` and optionally ``mask``,
        ``log_q``, ``mask_ids`` and ``dense`` (the engineered features). ``extra_candidates`` ``(emb, ids, corr)``
        appends negative columns to the retrieval softmax. ``neg_item_ids``
        [B, K] adds ``explicit_negatives_weight`` times the explicit
        softmax over [positive | K negatives] (the negatives through the
        item tower, their dropout drawn after the forward's).

        Inside the trainer's data-parallel step ``data_axis`` names the
        batch axis of ``mesh_ctx`` (the :class:`MeshContext`, whose
        ``data_axis_size`` ranks each hold a slice of the global batch):
        the BCE always divides by the global weight sum, and with
        ``global_negatives`` the in-batch softmax's candidates are the
        global batch (``data_axis_size * B_local`` of them, which the path
        policy and the bf16 threshold count). Explicit negatives stay
        local. ``lookup(table, ids) -> rows`` replaces the towers' table
        gather, the explicit negatives' too (the trainer passes the
        row-sharded tables' psum or a2a lookup, ``embed/table.py``);
        ``item_bias`` is read by a plain gather."""
        if data_axis is not None and mesh_ctx is None:
            raise ValueError(f"data_axis {data_axis!r} needs the mesh_ctx that resolves it")
        glob = data_axis is not None and global_negatives
        retr_axis = data_axis if glob else None
        out = MultiTaskModel.apply(params, cfg, batch["user_id"], batch["movie_id"],
                                   dense=batch.get("dense"), train=train,
                                   generator=generator, lookup=lookup)
        mask = batch.get("mask")
        movie_id = batch["movie_id"].long()
        if cfg.use_item_bias:
            item_bias = params["towers"]["item_bias"]
            bias = item_bias[movie_id.clamp(0, item_bias.shape[0] - 1)]
        else:
            # ablation: no bias column, no gradient into item_bias
            bias = torch.zeros(movie_id.shape, dtype=torch.float32, device=movie_id.device)
        # ids for accidental-hit masking ("mask_ids" when the caller feeds
        # other row ids through "movie_id")
        mask_ids = batch.get("mask_ids", batch["movie_id"])
        if not cfg.accidental_hit_mask:
            # ablation: per-row ids that never collide = no masking (unique
            # over the global batch under global negatives too)
            b_rows = movie_id.shape[0]
            mask_ids = torch.arange(b_rows, dtype=torch.int32, device=movie_id.device)
            if glob:
                mask_ids = mask_ids + mesh_ctx.axis_index(data_axis) * b_rows
        emb_dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        # temperature scales the user side only: every logit and the
        # positive scale together, so serving rankings do not change
        u_retr = out.user_embedding
        if cfg.softmax_temperature != 1.0:
            u_retr = u_retr / cfg.softmax_temperature
        # under global negatives the candidate axis spans the global batch
        n_candidates = u_retr.shape[0] * (data_axis_size if glob else 1)
        if extra_candidates is not None:
            n_candidates += extra_candidates[0].shape[0]
        loss_path = losses.resolve_retrieval_loss(
            cfg.use_flash_ce, u_retr.shape[0], n_candidates, u_retr.device.type,
            cfg.retrieval_logits_cap_gb)
        common = dict(mask=mask, log_q=batch.get("log_q"), item_bias=bias,
                      extra_candidates=extra_candidates, axis_name=retr_axis,
                      mesh_ctx=mesh_ctx)
        if loss_path == "flash":
            from recsys_tpu_torch.ops.flash_ce import in_batch_softmax_flash

            retr = in_batch_softmax_flash(
                u_retr.to(emb_dtype), out.item_embedding.to(emb_dtype),
                item_ids=mask_ids, bf16=cfg.bf16_retrieval_logits, **common)
        elif loss_path == "chunked":
            retr = losses.in_batch_softmax_chunked(
                u_retr.to(emb_dtype), out.item_embedding.to(emb_dtype),
                item_ids=mask_ids, **common)
        else:
            bf16_logits = cfg.bf16_retrieval_logits is True or (
                cfg.bf16_retrieval_logits == "auto"
                and n_candidates >= losses.BF16_LOGITS_MIN_CANDIDATES)
            retr = losses.in_batch_softmax(
                u_retr.to(emb_dtype), out.item_embedding.to(emb_dtype),
                item_ids=mask_ids,
                logits_dtype=torch.bfloat16 if bf16_logits else None, **common)
        if neg_item_ids is not None:
            # the model's own embeddings, without the in-batch term's cast
            neg_emb = TwoTower.item_embed(params["towers"], neg_item_ids, cfg, train=train,
                                          generator=generator, lookup=lookup)
            retr = retr + cfg.explicit_negatives_weight * losses.sampled_softmax_explicit(
                u_retr, out.item_embedding, neg_emb)
        m = losses.mse(out.rating_pred, batch["rating"], mask=mask)
        w_pos, w_neg = class_weights
        # the BCE's denominator is global whatever the negatives' scope:
        # the objective must not change with the data-parallel layout
        bce = losses.weighted_bce_logits(out.ctr_logit, batch["y_implicit"], w_pos,
                                         w_neg, mask=mask, axis_name=data_axis,
                                         mesh_ctx=mesh_ctx)
        reg = L.l2_penalty(
            {"dcn_deep": params["dcn"]["deep"],
             "towers": {k: params["towers"][k] for k in ("user_tower", "item_tower")}},
            cfg.l2_reg)
        total = (cfg.retrieval_weight * retr + cfg.rating_weight * m
                 + cfg.ctr_weight * bce + reg)
        metrics = {"loss": total, "retrieval_loss": retr, "rating_mse": m,
                   "ctr_bce": bce, "l2": reg}
        return total, metrics
