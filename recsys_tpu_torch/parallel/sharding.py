"""Batch and table placement on the mesh (the counterpart of
``recsys_tpu/parallel/sharding.py``).

Each rank holds only its own ``data`` slice of a batch, on its device.
A row-sharded table (``rows_sharding``: ``P("model", None)``) is held as
this rank's ``model`` slice of its rows (:func:`shard_rows`), and
:func:`table_chunks` brings the whole table's rows, in order, a chunk at a
time, to the host of the axis's first rank: :func:`gather_table` puts them
together there (the JAX package's ``device_get``), and the checkpoint
writer streams them to disk, so no card, and no host of a checkpoint,
holds a whole table.
The JAX package's other ``NamedSharding`` helpers (``replicated``,
``batch_sharding``) have no counterpart: a rank's tensors are its shard,
and what is replicated is what every rank holds whole.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from recsys_tpu_torch.parallel.mesh import MeshContext

# the rows a model rank sends to the first one at a time in
# ``table_chunks``, in bytes: the first rank holds one such chunk at once
GATHER_CHUNK_BYTES = 256 << 20


def _local(ctx: MeshContext, x, axis: int) -> np.ndarray:
    x = np.asarray(x)
    local = ctx.local_batch(x.shape[axis])
    rows = [slice(None)] * x.ndim
    rows[axis] = slice(ctx.data_index * local, (ctx.data_index + 1) * local)
    return np.ascontiguousarray(x[tuple(rows)])


def _data_slice(ctx: MeshContext, x, axis: int) -> torch.Tensor:
    return torch.from_numpy(_local(ctx, x, axis)).to(ctx.device)


def local_slice(ctx: MeshContext, batch: Any, axis: int = 0) -> Any:
    """This rank's ``data`` slice of each array of a host batch (split on
    ``axis``), still on the host: for a caller that places it itself (the
    trainer's pinned, side-stream copies)."""
    return tree_map(lambda x: _local(ctx, x, axis), batch)


def shard_batch(ctx: MeshContext, batch: Any) -> Any:
    """This rank's slice of a host batch (a dict, list or tuple of arrays
    with the global batch on axis 0): axis 0 split over ``data``, on the
    rank's device."""
    return tree_map(lambda x: _data_slice(ctx, x, 0), batch)


def shard_batch_chunk(ctx: MeshContext, chunk: Any) -> Any:
    """This rank's slice of a ``[K, B, ...]`` stack of K consecutive
    batches, moved in one transfer: axis 1 (the batch) split over
    ``data``, axis 0 (the step) whole."""
    return tree_map(lambda x: _data_slice(ctx, x, 1), chunk)


def shard_rows(ctx: MeshContext, table: torch.Tensor) -> torch.Tensor:
    """This rank's ``model`` slice of a whole table: rows ``[m * V / n,
    (m + 1) * V / n)`` for model index ``m`` of ``n`` (``V`` must divide;
    ``TwoTower.init(rows_multiple=n)`` pads it so). A view of ``table``."""
    n, m = ctx.n_model, ctx.model_index
    if table.shape[0] % n:
        raise ValueError(f"a table of {table.shape[0]} rows does not split over "
                         f"{n} model ranks: pad it (rows_multiple={n})")
    rows = table.shape[0] // n
    return table[m * rows:(m + 1) * rows]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def table_chunks(ctx: MeshContext, shard: torch.Tensor, chunk_bytes: Optional[int] = None
                 ) -> Iterator[Tuple[int, np.ndarray]]:
    """The whole table's rows in order, every model rank's shard in axis
    order, as (first row, rows) numpy chunks of about ``chunk_bytes``
    (``GATHER_CHUNK_BYTES``) on the host of this rank's ``model`` group's
    first rank; the group's other ranks send theirs and yield nothing. A
    collective over ``model`` (every rank of the group runs it to its end;
    outside autograd): the first rank receives one chunk at a time, each
    on the host before the next is asked for, so it holds one chunk
    besides its shard."""
    n, me = ctx.n_model, ctx.model_index
    group = ctx.group(ctx.model_axis)
    shard = shard.detach()
    rows = shard.shape[0]
    row_bytes = max(shard[:1].numel() * shard.element_size(), 1)
    step = max(1, (GATHER_CHUNK_BYTES if chunk_bytes is None else chunk_bytes) // row_bytes)
    for m in range(n):
        if me not in (0, m):
            continue
        for lo in range(0, rows, step):
            part = shard[lo:lo + step].contiguous()
            if me == m and m > 0:
                dist.send(part, dst=dist.get_global_rank(group, 0), group=group)
                continue
            if m > 0:
                host = np.empty(tuple(part.shape), numpy_dtype(part.dtype))
                buf = torch.from_numpy(host) if part.device.type == "cpu" \
                    else torch.empty_like(part)
                dist.recv(buf, src=dist.get_global_rank(group, m), group=group)
                part = buf
            yield m * rows + lo, part.cpu().numpy()


def gather_table(ctx: MeshContext, shard: torch.Tensor,
                 chunk_bytes: Optional[int] = None) -> Optional[np.ndarray]:
    """The whole table as a numpy array on the host of this rank's
    ``model`` group's first rank, put together from :func:`table_chunks`;
    None on the group's other ranks. A collective over ``model``."""
    out = None
    if ctx.model_index == 0:
        out = np.empty((ctx.n_model * shard.shape[0],) + tuple(shard.shape[1:]),
                       numpy_dtype(shard.dtype))
    for lo, rows in table_chunks(ctx, shard, chunk_bytes):
        out[lo:lo + rows.shape[0]] = rows
    return out


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad ``x`` along ``axis`` to a multiple (static-shape friendly).
    Returns (padded, original_length)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill), n
