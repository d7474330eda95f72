"""Batch placement on the mesh (the counterpart of
``recsys_tpu/parallel/sharding.py``).

Each rank holds only its own ``data`` slice of a batch, on its device.
The JAX package's ``NamedSharding`` helpers (``replicated``,
``batch_sharding``, ``rows_sharding``) have no counterpart: a rank's
tensors are its shard, and what is replicated is what every rank holds
whole.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_map

from recsys_tpu_torch.parallel.mesh import MeshContext


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
