"""Pooled multi-hot embedding bags over one concatenated table: the CUDA
kernels of ``csrc/embedding_bag.cu`` and their plain PyTorch versions.
No TPU kernel corresponds: the JAX package has no multi-hot model; these
serve DLRM-DCNv2 (``models/dlrm.py``).

The tables of a model lie end to end in one fp32 table [n_rows, D] (table
t from row ``BagLayout.row_offset[t]``, as FBGEMM's table-batched
embedding holds them). A batch's ids are [B, S] int32: the fixed-size
bags of every table side by side (bag t in columns ``bag_start[t]`` to
``bag_start[t + 1] - 1``), each id local to its table; an id outside its
table is clamped to it, as the two-tower tables' gather clamps.

* :func:`bag_forward` sums each bag's rows -> [B, T, D] fp32, in one
  launch on the card;
* :func:`bag_backward_rowwise_adagrad` takes the bags' gradient [B, T, D]
  and updates, in place, every row the batch looked up and its row-wise
  Adagrad accumulator (FBGEMM's exact row-wise Adagrad): the rows'
  gradients are summed from the bags' through one sort of the lookups'
  global rows, with static shapes, no host sync and no [B * S, D] tensor.
  It returns the step's counters (lookups, rows updated) as device
  scalars. Two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.train.optimizer import sparse_rowwise_adagrad_combined
from recsys_tpu_torch.utils.debug import kernel_nan_check

MAX_DIM = 512  # the kernels hold up to 4 float4s of a row a lane
ROWWISE_EPS = 1e-8  # FBGEMM's row-wise Adagrad eps


class BagLayout(NamedTuple):
    """Where each table and bag lies. Tensors on one device."""
    bag_start: torch.Tensor   # [T + 1] int32: each bag's first column, then S
    row_offset: torch.Tensor  # [T] int64: each table's first row
    rows: torch.Tensor        # [T] int32: each table's rows
    col_bag: torch.Tensor     # [S] int32: each column's bag
    col_offset: torch.Tensor  # [S] int32: the first row of each column's table
    n_rows: int
    table_rows: Tuple[int, ...]
    bag_sizes: Tuple[int, ...]


def make_layout(table_rows: Sequence[int], bag_sizes: Sequence[int], device) -> BagLayout:
    """The layout of tables of ``table_rows`` rows with bags of ``bag_sizes``."""
    if len(table_rows) != len(bag_sizes) or not table_rows:
        raise ValueError("want one bag size a table")
    n_rows = sum(table_rows)
    if n_rows >= 2**31:
        raise ValueError(f"{n_rows} rows: the global row ids are int32")
    starts = [0]
    for h in bag_sizes:
        starts.append(starts[-1] + h)
    offsets = [0]
    for r in table_rows[:-1]:
        offsets.append(offsets[-1] + r)
    col_bag = [t for t, h in enumerate(bag_sizes) for _ in range(h)]
    i32 = dict(dtype=torch.int32, device=device)
    return BagLayout(
        bag_start=torch.tensor(starts, **i32),
        row_offset=torch.tensor(offsets, dtype=torch.int64, device=device),
        rows=torch.tensor(list(table_rows), **i32),
        col_bag=torch.tensor(col_bag, **i32),
        col_offset=torch.tensor([offsets[t] for t in col_bag], **i32),
        n_rows=n_rows, table_rows=tuple(table_rows), bag_sizes=tuple(bag_sizes))


def global_rows(ids: torch.Tensor, layout: BagLayout) -> torch.Tensor:
    """[B, S] table-local ids -> their rows of the concatenated table
    (int32, clamped to each table)."""
    col_rows = layout.rows[layout.col_bag]
    return torch.minimum(torch.clamp(ids, min=0), col_rows - 1) + layout.col_offset


def bag_forward_reference(table: torch.Tensor, ids: torch.Tensor,
                          layout: BagLayout) -> torch.Tensor:
    """Plain version of the forward: each bag's rows added in order to a
    zero sum (the kernel's arithmetic, bit for bit)."""
    rows = global_rows(ids, layout).long()
    out = table.new_zeros((ids.shape[0], len(layout.bag_sizes), table.shape[1]))
    c = 0
    for t, h in enumerate(layout.bag_sizes):
        acc = out[:, t]
        for j in range(h):
            acc = acc + table[rows[:, c + j]]
        out[:, t] = acc
        c += h
    return out


def combine_bag_rows_reference(ids: torch.Tensor, bag_grad: torch.Tensor,
                               layout: BagLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward's sum: -> (the looked-up rows,
    ascending [U], their summed gradients [U, D]), a column of lookups at
    a time (no [B * S, D] tensor). Shapes depend on the data."""
    rows = global_rows(ids, layout).long()
    uniq, inv = torch.unique(rows, return_inverse=True)
    combined = bag_grad.new_zeros((uniq.shape[0], bag_grad.shape[2]))
    for c in range(rows.shape[1]):
        combined.index_add_(0, inv[:, c], bag_grad[:, int(layout.col_bag[c])])
    return uniq, combined


def _check(table: torch.Tensor, ids: torch.Tensor, layout: BagLayout, what: str) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"{what}: want a contiguous fp32 table [n_rows, D]")
    if table.shape[0] != layout.n_rows:
        raise ValueError(f"{what}: the table has {table.shape[0]} rows, the layout "
                         f"{layout.n_rows}")
    d = table.shape[1]
    if d % 4 or d > MAX_DIM:
        raise ValueError(f"{what}: D = {d} must be a multiple of 4, at most {MAX_DIM}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or ids.shape[1] != layout.col_bag.shape[0]:
        raise ValueError(f"{what}: want int32 ids [B, {layout.col_bag.shape[0]}], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    for name, t in (("ids", ids), ("layout", layout.bag_start)):
        if t.device != table.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the table on {table.device}")


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().embedding_bag_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().embedding_bag_bwd_rowwise_adagrad
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@kernel_nan_check("embedding_bag (the pooled multi-hot lookup)")
def bag_forward(table: torch.Tensor, ids: torch.Tensor, layout: BagLayout) -> torch.Tensor:
    """table [n_rows, D] fp32, ids [B, S] int32 -> the bags [B, T, D] fp32.
    CPU tensors take :func:`bag_forward_reference`; CUDA tensors launch the
    kernel or raise. No gradient flows back through it: the caller takes
    the bags' gradient to :func:`bag_backward_rowwise_adagrad`."""
    _check(table, ids, layout, "bag_forward")
    if table.device.type == "cpu":
        return bag_forward_reference(table, ids, layout)
    if table.device.type != "cuda":
        raise ValueError(f"bag_forward: unsupported device {table.device}")
    ids = ids.contiguous()
    b, n_bags = ids.shape[0], len(layout.bag_sizes)
    out = torch.empty((b, n_bags, table.shape[1]), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_launcher()(table.data_ptr(), ids.data_ptr(), layout.bag_start.data_ptr(),
                              layout.row_offset.data_ptr(), layout.rows.data_ptr(),
                              out.data_ptr(), b, ids.shape[1], n_bags, table.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError {err}")
    if b:
        _BAG_FORWARD.launches += 1
    return out


# the counts are kept on the functions as defined here, reached through
# these names, so a wrapper installed on the module's attribute (a traced
# benchmark run's) takes no count of its own
bag_forward.launches = 0
_BAG_FORWARD = bag_forward


@torch.no_grad()
def bag_backward_rowwise_adagrad(table: torch.Tensor, accum: torch.Tensor, ids: torch.Tensor,
                                 bag_grad: torch.Tensor, layout: BagLayout, lr: float,
                                 eps: float = ROWWISE_EPS
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bags' gradient [B, T, D] back to every looked-up row of
    ``table`` [n_rows, D], each row updated once by row-wise Adagrad with
    its accumulator ``accum`` [n_rows] (both fp32, in place):
    ``accum[r] += mean(g_r**2); table[r] -= lr * g_r / (sqrt(accum[r]) +
    eps)``. -> (lookups, rows updated), fp32 scalars on the device.

    CPU tensors take the plain versions (:func:`combine_bag_rows_reference`
    and ``optimizer.sparse_rowwise_adagrad_combined``); CUDA tensors sort
    the lookups' rows (one ``torch.sort``) and launch the two kernels, or
    raise."""
    _check(table, ids, layout, "bag_backward_rowwise_adagrad")
    b, s = ids.shape
    d = table.shape[1]
    if bag_grad.shape != (b, len(layout.bag_sizes), d) or bag_grad.dtype != torch.float32:
        raise ValueError(f"bag_backward_rowwise_adagrad: want fp32 bag gradients "
                         f"{(b, len(layout.bag_sizes), d)}, got {tuple(bag_grad.shape)}")
    if accum.shape != (layout.n_rows,) or accum.dtype != torch.float32:
        raise ValueError("bag_backward_rowwise_adagrad: want an fp32 accumulator [n_rows]")
    lookups = torch.full((), float(b * s), device=table.device)
    if table.device.type == "cpu":
        uniq, combined = combine_bag_rows_reference(ids, bag_grad, layout)
        valid = torch.ones(uniq.shape, dtype=torch.bool)
        sparse_rowwise_adagrad_combined(table, accum, uniq, combined, valid, lr, eps)
        return lookups, torch.full((), float(uniq.shape[0]))
    if table.device.type != "cuda":
        raise ValueError(f"bag_backward_rowwise_adagrad: unsupported device {table.device}")
    n = b * s
    if n >= 2**31:
        raise ValueError(f"bag_backward_rowwise_adagrad: {n} lookups; at most 2**31 - 1")
    keys, pos = torch.sort(global_rows(ids, layout).view(-1), stable=True)
    bag_grad = bag_grad.contiguous()
    partial = torch.empty((max(-(-n // 32), 1), 2, d), dtype=torch.float32,
                          device=table.device)
    counter = torch.zeros((), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(table.data_ptr(), accum.data_ptr(), keys.data_ptr(),
                              pos.data_ptr(), bag_grad.data_ptr(), layout.col_bag.data_ptr(),
                              partial.data_ptr(), counter.data_ptr(), n, s,
                              len(layout.bag_sizes), d, lr, eps, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_bwd kernel launch failed: cudaError {err}")
    if n:
        _BAG_BACKWARD.launches += 1
    return lookups, counter.to(torch.float32)


bag_backward_rowwise_adagrad.launches = 0
_BAG_BACKWARD = bag_backward_rowwise_adagrad
