"""Named collectives over the axes of a :class:`MeshContext` (the
counterpart of ``recsys_tpu/parallel/collectives.py``).

Each function is the body of a JAX ``shard_map`` seen from one rank: it
takes this rank's local tensors and an axis name, resolves the axis to
the process group of the ranks that share this rank's other coordinate,
and returns this rank's result. Every rank of that group must make the
same call in the same order. Higher layers (the sharded top-k, the
training step's gradient sync and lookups) reach ``torch.distributed``
only through these.

:func:`all_gather_rows` is the one differentiable collective: the
data-parallel step gathers the item embeddings (and their column
corrections) of every rank through it, and its backward hands each rank
the sum over ranks of the cotangent of its own rows.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from recsys_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, MeshContext


# ---- data-parallel gradient sync -------------------------------------------

def allreduce_sum(ctx: MeshContext, tree: Any, axis: str = DATA_AXIS) -> Any:
    """Sum every tensor of ``tree`` (a dict, list or tuple of tensors,
    nested or not) over ``axis``; the inputs are left as they are."""
    group = ctx.group(axis)

    def reduce(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    return tree_map(reduce, tree)


def allreduce_mean(ctx: MeshContext, tree: Any, axis: str = DATA_AXIS) -> Any:
    """Mean of every tensor of ``tree`` over ``axis`` (``lax.pmean``)."""
    n = ctx.axis_size(axis)
    return tree_map(lambda x: x / n, allreduce_sum(ctx, tree, axis))


def allreduce_mean_flat(ctx: MeshContext, tensors: Sequence[torch.Tensor],
                        axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """Mean over ``axis`` of each tensor of a list of fp32 tensors (the
    step's gradients) in ONE collective: flattened into one buffer, summed,
    divided by the axis size and split back into the tensors' shapes. Every
    rank gets the same bits. The inputs are left as they are."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=ctx.group(axis))
    flat /= ctx.axis_size(axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _AllGatherRows(torch.autograd.Function):
    """Tiled all-gather on dim 0 whose backward is the sum reduce-scatter
    of the cotangent (the transpose of ``lax.all_gather(tiled=True)``)."""

    @staticmethod
    def forward(fctx, x, mesh_ctx, axis):
        fctx.mesh_ctx, fctx.axis = mesh_ctx, axis
        return _all_gather(mesh_ctx, x, axis, dim=0)

    @staticmethod
    def backward(fctx, g):
        ctx, axis = fctx.mesh_ctx, fctx.axis
        n = ctx.axis_size(axis)
        parts = list(g.contiguous().chunk(n))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group(axis))
        return out, None, None


def all_gather_rows(ctx: MeshContext, x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in axis order, differentiable:
    rank r's loss L_r reads every rank's rows, and the gradient of the
    global objective with respect to this rank's rows needs the sum over r
    of dL_r/d(rows), which the backward's reduce-scatter sums. (Keeping
    only this rank's slice of the cotangent, or averaging it, differentiates
    another objective.)"""
    return _AllGatherRows.apply(x, ctx, axis)


# ---- model-axis exchange ------------------------------------------------

def gather_rows(ctx: MeshContext, x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
    """All-gather along dim 0 in axis order (a tiled ``lax.all_gather``)."""
    return _all_gather(ctx, x, axis, dim=0)


def exchange(ctx: MeshContext, x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
    """All-to-all on dim 0: ``x`` is ``n`` equal chunks, chunk j goes to
    the rank at index j of ``axis``, and chunk j of the result is the one
    that rank sent here (the id and row exchange of the sharded lookup)."""
    n = ctx.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"exchange: {x.shape[0]} rows do not split into {n} chunks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ctx.group(axis))
    return out


def ring_shift(ctx: MeshContext, x: torch.Tensor, axis: str = MODEL_AXIS,
               shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank at index ``(i + shift) % n`` of ``axis`` and
    return what the rank at ``(i - shift) % n`` sent (``lax.ppermute``
    around the ring)."""
    n = ctx.axis_size(axis)
    if shift % n == 0:
        return x.clone()
    group = ctx.group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = ctx.axis_index(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group=group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---- sharded top-k merge ------------------------------------------------

def merge_topk(ctx: MeshContext, scores: torch.Tensor, ids: torch.Tensor, k: int,
               axis: str = MODEL_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each rank's top-k candidates ``[..., k_local]`` (global ids)
    into the global top ``k``: all-gather them on the last dim over
    ``axis`` (k_local * n values, tiny beside the catalog) and select
    again. Equal scores keep the lower position, shard 0's first, as
    ``lax.top_k`` does."""
    all_scores = _all_gather(ctx, scores, axis, dim=-1)
    all_ids = _all_gather(ctx, ids, axis, dim=-1)
    top, pos = torch.sort(all_scores, dim=-1, descending=True, stable=True)
    pos = pos[..., :k]
    return top[..., :k], torch.take_along_dim(all_ids, pos, dim=-1)


def axis_index(ctx: MeshContext, axis: str) -> int:
    return ctx.axis_index(axis)


def axis_size(ctx: MeshContext, axis: str) -> int:
    return ctx.axis_size(axis)


def _all_gather(ctx: MeshContext, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    x = x.detach()
    parts = [torch.empty_like(x) for _ in range(ctx.axis_size(axis))]
    dist.all_gather(parts, x.contiguous(), group=ctx.group(axis))
    return torch.cat(parts, dim=dim)
