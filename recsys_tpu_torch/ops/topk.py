"""Blockwise top-k over large catalogs, and the int8 catalog (the
counterpart of ``recsys_tpu/ops/topk.py``).

* :func:`blockwise_topk` scores the catalog in blocks of ``block_size``
  items with a running top-k: peak memory O(Q * (k + block)) instead of
  O(Q * N). Each block is one product, a block-local ``torch.topk`` of
  min(k, block) and a merge into the running [Q, k].
* :func:`quantize_rows` / :func:`blockwise_topk_int8` score against a
  symmetric per-row int8 catalog with exact integer products.

None of these is a kernel of the JAX package (there they are XLA code
around ``lax.scan``), so the products here are library products.

What differs from the JAX package: ``approx=True`` there selects with the
TPU's ``lax.approx_max_k``, which Hopper does not have. Off the TPU that
op selects exactly, and so does this port: ``approx`` only rounds the
operands of :func:`blockwise_topk` to bf16 (products summed in fp32), and
changes nothing in :func:`blockwise_topk_int8`.

* :func:`make_ring_topk` passes item shards around the ``model`` axis of
  a mesh, each rank scoring every shard in turn with the exact top-k.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from recsys_tpu_torch.ops.topk_flash import NEG_INF, l2_normalize

# 127**2 * d stays below 2**24 up to this width, so an fp32 sum of int8
# products is exact integer arithmetic in any order
_INT8_FP32_EXACT_MAX_D = (1 << 24) // (127 * 127)


def _merge(run_s, run_i, new_s, new_i, k: int):
    s = torch.cat([run_s, new_s], dim=1)
    i = torch.cat([run_i, new_i], dim=1)
    top_s, pos = torch.topk(s, k, dim=1)
    return top_s, torch.gather(i, 1, pos)


def _blockwise_scan(score_block, n: int, q_n: int, k: int, block_size: int,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over ``ceil(n / block_size)`` blocks.
    ``score_block(lo, hi) -> [Q, hi - lo]`` fp32 scores of items
    [lo, hi). As in the JAX scan, the tail block counts as a full block:
    its missing items score ``NEG_INF`` with the last id (clipped), so
    k > N yields ``NEG_INF`` past N."""
    kk = min(k, block_size)
    run_s = torch.full((q_n, k), NEG_INF, dtype=torch.float32, device=device)
    run_i = torch.zeros((q_n, k), dtype=torch.long, device=device)
    for lo in range(0, n, block_size):
        hi = min(n, lo + block_size)
        scores = score_block(lo, hi)
        b_s, b_i = torch.topk(scores, min(kk, hi - lo), dim=1)
        b_i = b_i + lo
        if b_s.shape[1] < kk:  # padded tail slots
            pad = kk - b_s.shape[1]
            b_s = torch.cat([b_s, b_s.new_full((q_n, pad), NEG_INF)], dim=1)
            b_i = torch.cat([b_i, b_i.new_full((q_n, pad), n - 1)], dim=1)
        run_s, run_i = _merge(run_s, run_i, b_s, b_i, k)
    return run_s, run_i


def blockwise_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                   block_size: int = 4096, normalize: bool = True,
                   approx: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] x [N, d] -> (scores [Q, k] fp32, ids [Q, k] int64) without
    forming [Q, N]. ``approx=True`` scores bf16-rounded operands (their
    products are exact in fp32); the selection is exact either way.
    ``blockwise_topk.calls`` counts the calls."""
    blockwise_topk.calls += 1
    u, v = user_emb.float(), item_emb.float()
    if normalize:
        u, v = l2_normalize(u), l2_normalize(v)
    if approx:
        u = u.to(torch.bfloat16).float()
        v = v.to(torch.bfloat16).float()
    return _blockwise_scan(lambda lo, hi: torch.matmul(u, v[lo:hi].T),
                           v.shape[0], u.shape[0], k, block_size, u.device)


blockwise_topk.calls = 0


def quantize_rows(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``emb ~ q * scale``, q in [-127, 127].
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q``
    equals the JAX package's bit for bit. -> (q [N, d] int8, scale [N] fp32)."""
    emb = emb.float()
    absmax = torch.clamp(emb.abs().amax(dim=-1, keepdim=True), min=1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(emb / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def blockwise_topk_int8(user_emb: torch.Tensor, item_q: torch.Tensor,
                        item_scale: torch.Tensor, k: int, block_size: int = 65536,
                        approx: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise top-k over an int8 catalog from :func:`quantize_rows`
    (quantized after normalizing, for cosine scores). Queries are
    quantized per row; each block's integer product is exact, as the JAX
    package's int8 x int8 -> int32 product: the int8 values are multiplied
    as fp32 (exact up to d = 1,040, see ``_INT8_FP32_EXACT_MAX_D``) or
    fp64 above, then rescaled to fp32. ``approx`` is accepted for the JAX
    signature; the selection is exact."""
    del approx
    uq, us = quantize_rows(user_emb)
    d = uq.shape[1]
    acc_t = torch.float32 if d <= _INT8_FP32_EXACT_MAX_D else torch.float64
    uq = uq.to(acc_t)

    def score(lo, hi):
        acc = torch.matmul(uq, item_q[lo:hi].to(acc_t).T)
        return acc.float() * (us[:, None] * item_scale[None, lo:hi])

    return _blockwise_scan(score, item_q.shape[0], uq.shape[0], k, block_size,
                           uq.device)


def make_ring_topk(ctx, k: int, normalize: bool = True) -> Callable:
    """Ring scorer over item shards on the ``model`` axis of ``ctx`` (a
    :class:`~recsys_tpu_torch.parallel.mesh.MeshContext`).

    Returns ``f(user_local [Q / n_data, d], item_shard [rows, d]) ->
    (scores [Q / n_data, k], global ids [Q / n_data, k])`` for this rank's
    ``data`` slice of the queries and its shard of the catalog. Each of
    the ``n_model`` steps scores the shard this rank holds with
    ``scorer.exact_topk`` (the flash top-k kernel on the card for k <=
    256), offsets its ids by the shard's origin, merges the result into
    the running top-k and passes the shard on to the next rank of the
    ring. Shards must be equal in size (pad the catalog to a multiple of
    ``n_model``)."""
    from recsys_tpu_torch.parallel.collectives import ring_shift
    from recsys_tpu_torch.retrieval.scorer import exact_topk

    n_shards = ctx.n_model

    def ring(user_local: torch.Tensor, item_shard: torch.Tensor):
        u = user_local.float()
        if normalize:
            u = l2_normalize(u)
        rows = item_shard.shape[0]
        kk = min(k, rows)
        run_s = torch.full((u.shape[0], k), NEG_INF, dtype=torch.float32, device=u.device)
        run_i = torch.zeros((u.shape[0], k), dtype=torch.long, device=u.device)
        shard = item_shard
        for s in range(n_shards):
            # the shard held now started at (my - s) mod n_shards
            origin = (ctx.model_index - s) % n_shards
            v = l2_normalize(shard.float()) if normalize else shard.float()
            b_s, b_i = exact_topk(u, v, kk, normalize=False)
            run_s, run_i = _merge(run_s, run_i, b_s, b_i + origin * rows, k)
            if s + 1 < n_shards:
                shard = ring_shift(ctx, shard, ctx.model_axis)
        return run_s, run_i

    return ring
