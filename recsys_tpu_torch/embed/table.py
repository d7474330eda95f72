"""Row-sharded embedding lookups (the counterpart of
``recsys_tpu/embed/table.py``).

A table too large for one card is split by rows over the ``model`` axis
of the mesh: rank ``m`` of ``n`` holds rows ``[m * V / n, (m + 1) * V /
n)`` (``parallel.sharding.shard_rows``). The ranks that share a ``data``
index hold the same ids, and each needs every id's row. Two strategies,
both differentiable through autograd (the backward is the gather's
scatter-add into this rank's rows, carried back through the
collectives):

1. **psum** (:func:`lookup_psum_inside`): every shard gathers the ids it
   owns (others masked to zero) and the results are summed over
   ``model``: one all-reduce of ``[B, D]``. An id that no shard owns (out
   of range) gets a zero row.
2. **all-to-all** (:func:`lookup_a2a_inside`): ids are bucketed by owner
   shard into fixed-capacity bins (a counting rank, no sort), exchanged,
   gathered by their owner and exchanged back: two all-to-alls of
   ``[n * capacity]`` ids and ``[n * capacity, D]`` rows. Ids past their
   bucket's capacity are served a ZERO row and counted (the JAX module's
   docstrings say "the OOV row" and "row 0": its code serves zeros, and
   so does this one). An out-of-range id goes to the nearest shard
   (owner clipped to ``[0, n - 1]``) and reads that shard's first or last
   row.

:func:`lookup_replicated` is the plain gather of a whole table, its ids
clipped to the last row (the towers' default). The trainer's step calls
the psum lookup and :func:`lookup_a2a` on its own shards; the ``make_*``
forms are the standalone lookups (the
JAX package's ``shard_map`` over ``P("model", None)`` tables and
``P("data")`` ids): each takes this rank's table shard and this rank's
``data`` slice of the ids and returns this rank's slice of the rows.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from recsys_tpu_torch.parallel import collectives
from recsys_tpu_torch.parallel.mesh import MeshContext


def lookup_replicated(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The gather of a whole table, ids clipped to ``[0, V - 1]`` (the
    towers' clip-to-OOV gather)."""
    return table[torch.as_tensor(ids, device=table.device).long().clamp(0, table.shape[0] - 1)]


def lookup_psum_inside(ctx: MeshContext, table_shard: torch.Tensor, ids: torch.Tensor,
                       axis: str) -> torch.Tensor:
    """The masked local gather + psum body: each rank gathers the ids its
    shard owns, zero rows for the rest, and the rows are summed over
    ``axis`` (:func:`collectives.psum`, whose backward is the identity).
    No clip beyond the shard's own rows: an id no shard owns reads zeros."""
    rows_per_shard = table_shard.shape[0]
    local = ids.long() - ctx.axis_index(axis) * rows_per_shard
    own = (local >= 0) & (local < rows_per_shard)
    # the ids another shard owns read a row of this one, spread over its
    # rows (not all on one: the gather's backward would pile their zero
    # cotangents onto a single row, which the card serialises)
    rows = table_shard[local.remainder(rows_per_shard)]
    rows = torch.where(own[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
    return collectives.psum(ctx, rows, axis)


def make_sharded_lookup_psum(ctx: MeshContext) -> Callable:
    """-> ``f(table_shard [V / n, D], ids [B_local]) -> rows [B_local, D]``
    over ``model``, with the JAX standalone form's gradient: the true
    gradient of a loss of the rows with respect to this rank's shard."""

    def lookup(table_shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return lookup_psum_inside(ctx, table_shard, ids, ctx.model_axis)

    return lookup


def _owners(ids: torch.Tensor, rows_per_shard: int, n: int) -> torch.Tensor:
    # floor division, as the JAX package's ``ids // rows_per_shard``
    return torch.div(ids.long(), rows_per_shard, rounding_mode="floor").clamp(0, n - 1)


def lookup_a2a_inside(ctx: MeshContext, table_shard: torch.Tensor, ids: torch.Tensor,
                      axis: str, n: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity-bucketed all-to-all body -> ``(rows [B, D], overflow
    [])``: ``overflow`` counts this rank's ids that found their owner's
    bucket full and were served a zero row.

    Each id's place in its owner's bucket is a counting rank (a one-hot
    ``[B, n]`` and its cumulative sum, no sort), so the first ``capacity``
    ids of a bucket, in batch order, fit. Fitting ids write ``local_row +
    1`` into their own slot of an ``[n * capacity]`` send buffer (0 marks
    an empty slot); overflowing ids are routed to one spare slot past its
    end, which is cut off, so no fitting slot is written twice. The
    requests are exchanged, each owner gathers its rows (zero rows for
    empty slots), the rows are exchanged back, and each position reads its
    own slot: no inverse scatter. Differentiable with respect to
    ``table_shard`` through the row exchange (:func:`collectives.exchange`).
    Empty slots, and positions that did not fit, read rows spread over the
    table (then masked to zero), so the gathers' backward never piles many
    zero cotangents onto one row."""
    rows_per_shard = table_shard.shape[0]
    dev = table_shard.device
    ids = ids.long()
    owner = _owners(ids, rows_per_shard, n)
    one_hot = (owner[:, None] == torch.arange(n, device=dev)[None, :]).to(torch.int32)
    prefix = torch.cumsum(one_hot, dim=0)  # inclusive counts [B, n]
    pos_in_owner = torch.gather(prefix, 1, owner[:, None])[:, 0] - 1
    fits = pos_in_owner < capacity
    overflow = torch.sum(~fits)
    slot = owner * capacity + pos_in_owner
    local_row = ids - owner * rows_per_shard
    send = torch.zeros((n * capacity + 1,), dtype=torch.int32, device=dev)
    send.index_put_((torch.where(fits, slot, n * capacity),), (local_row + 1).to(torch.int32))
    req = collectives.exchange(ctx, send[:n * capacity], axis).long()
    spread = torch.arange(n * capacity, device=dev) % rows_per_shard
    got = table_shard[torch.where(req > 0, (req - 1).clamp(0, rows_per_shard - 1), spread)]
    zero = torch.zeros((), dtype=got.dtype, device=dev)
    got = torch.where((req > 0)[:, None], got, zero)
    back = collectives.exchange(ctx, got, axis)
    spread = torch.arange(ids.shape[0], device=dev) % (n * capacity)
    out = torch.where(fits[:, None], back[torch.where(fits, slot, spread)], zero)
    return out, overflow


def a2a_capacity(batch_per_shard: int, n_shards: int, capacity_factor: float) -> int:
    """The bucket size of the all-to-all (``MeshConfig.lookup_capacity_factor``):
    ``ceil(factor * B / n)`` rounded up to a multiple of 8, at least 8."""
    cap = math.ceil(capacity_factor * batch_per_shard / max(n_shards, 1))
    return max(8, -(-cap // 8) * 8)


def a2a_overflow(ids: torch.Tensor, rows_per_shard: int, n: int,
                 capacity: int) -> torch.Tensor:
    """The ids of ``ids`` that :func:`lookup_a2a_inside` would find past
    their bucket's ``capacity`` (the trainer's ``lookup_overflow``), from
    the per-owner counts alone."""
    owner = _owners(ids.reshape(-1), rows_per_shard, n)
    counts = torch.zeros((n,), dtype=torch.int64, device=ids.device).index_add_(
        0, owner, torch.ones_like(owner))
    return torch.sum(torch.clamp(counts - capacity, min=0))


def lookup_a2a(ctx: MeshContext, table_shard: torch.Tensor, ids: torch.Tensor,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lookup_a2a_inside` over ``model`` -> ``(rows, overflow)``,
    ``overflow`` this rank's. The rows' cotangent is divided by the model
    axis size on the way back (:func:`collectives.pmean_invariant`), as the
    JAX package divides the cotangent of an output replicated over
    ``model``: each model replica returns its requests' cotangent through
    the exchange, and the owner's shard sums them. The trainer's step calls
    it with each call's own capacity."""
    out, overflow = lookup_a2a_inside(ctx, table_shard, ids, ctx.model_axis, ctx.n_model,
                                      capacity)
    return collectives.pmean_invariant(ctx, out, ctx.model_axis), overflow


def make_sharded_lookup_a2a(ctx: MeshContext, capacity: int) -> Callable:
    """-> ``f(table_shard [V / n, D], ids [B_local]) -> (rows [B_local, D],
    overflow [])``: :func:`lookup_a2a` at a fixed ``capacity``, its
    ``overflow`` summed over ``data`` (the same on every rank)."""

    def lookup(table_shard: torch.Tensor, ids: torch.Tensor):
        out, overflow = lookup_a2a(ctx, table_shard, ids, capacity)
        return out, collectives.allreduce_sum(ctx, overflow, ctx.data_axis)

    return lookup
