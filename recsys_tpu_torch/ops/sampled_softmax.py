"""The sampled softmax of HSTU's and MLA-MoE's loss: the CUDA kernels of
``csrc/sampled_softmax.cu`` (kernel row 13) and their plain PyTorch
version. No TPU kernel corresponds: the JAX package has no sequential
model; these serve ``models/losses.py::sampled_softmax``.

Rows q [M, D] meet K1 = K + 1 rows of a table [R, D] each (``ids`` [M,
K1]: the K negatives, then the positive): logits ``l_ik = q_i .
table[ids_ik] / t``, a negative equal to the positive masked to -inf; the
loss is the mean over rows of ``logsumexp_k l_ik - l_iK``. The backward is
two products of the logits' gradient G [M, K1] as a sparse [M, R] matrix:
``dq = G table`` and ``dtable = G^T q`` (a negative drawn twice for a row
counts twice). Neither version holds an [M, K, D] tensor: the plain one
gathers the rows ``PLAIN_CHUNK_ROWS`` rows of q at a time and takes the
backward's products as sparse-dense products; the kernels read each row
where they use it, and the card's ``dtable`` runs through the entries
sorted by id (one stable sort, in the forward) in runs of at most ``RUN``
entries of one item, so two calls give the same bits. Everything is
fp32.

CPU tensors take :func:`sampled_softmax_reference`; CUDA tensors the
kernels (D of 128, 256, 384, 512 or 2,048: MLA-MoE's hidden width) or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check

# rows of q whose negatives' rows [rows, K1, D] the plain version gathers at
# a time
PLAIN_CHUNK_ROWS = 4096
WIDTHS = (128, 256, 384, 512, 2048)


def _ids(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    return torch.cat([neg, pos[:, None]], dim=1)


def _masked(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    k = ids.shape[1] - 1
    hit = torch.cat([ids[:, :k] == ids[:, k:], torch.zeros_like(ids[:, k:], dtype=torch.bool)],
                    dim=1)
    return torch.where(hit, -float("inf"), logits)


def _grad(logits, lse, g, m: int, temperature: float) -> torch.Tensor:
    """d loss / d (q . e) [M, K1]: the softmax's probabilities (the
    positive's less 1), times g / (M t)."""
    out = torch.exp(logits - lse[:, None])
    out[:, -1] -= 1.0
    return out * (g / (max(m, 1) * temperature))


class _Plain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, table, pos, neg, temperature):
        ids = _ids(pos, neg)
        logits = torch.empty(ids.shape, dtype=torch.float32, device=q.device)
        for lo in range(0, q.shape[0], PLAIN_CHUNK_ROWS):
            sl = slice(lo, lo + PLAIN_CHUNK_ROWS)
            logits[sl] = torch.bmm(table[ids[sl]], q[sl, :, None])[:, :, 0] / temperature
        logits = _masked(logits, ids)
        lse = torch.logsumexp(logits, dim=1)
        ctx.save_for_backward(q, table, ids, logits, lse)
        ctx.temperature = temperature
        return torch.sum(lse - logits[:, -1]) / max(q.shape[0], 1)

    @staticmethod
    def backward(ctx, g):
        q, table, ids, logits, lse = ctx.saved_tensors
        m, k1 = ids.shape
        grad = _grad(logits, lse, g, m, ctx.temperature).reshape(-1)
        rows = torch.arange(m, device=q.device).repeat_interleave(k1)
        cols = ids.reshape(-1)
        gm = torch.sparse_coo_tensor(torch.stack([rows, cols]), grad, (m, table.shape[0]),
                                     check_invariants=False)
        gt = torch.sparse_coo_tensor(torch.stack([cols, rows]), grad, (table.shape[0], m),
                                     check_invariants=False)
        return torch.sparse.mm(gm, table), torch.sparse.mm(gt, q), None, None, None


def sampled_softmax_reference(q, table, pos, neg, temperature: float) -> torch.Tensor:
    """Plain version of row 13 (any device)."""
    return _Plain.apply(q, table, pos, neg, temperature)


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.load_library()
    fwd, dq, dt = lib.sampled_softmax_logits, lib.sampled_softmax_dq, lib.sampled_softmax_dtable
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] + [
        ctypes.c_void_p] * 2
    dq.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    dt.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    for fn in (fwd, dq, dt):
        fn.restype = ctypes.c_int
    return fwd, dq, dt


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


class SampledSoftmax(torch.autograd.Function):
    """Row 13 on the card: the logits kernel, then the sort of the entries
    by id (forward); the dq and dtable kernels (backward)."""

    @staticmethod
    def forward(ctx, q, table, pos, neg, temperature):
        ids = _ids(pos, neg).to(torch.int32).contiguous()
        logits = sampled_logits(q, table, ids, temperature)
        lse = torch.logsumexp(logits, dim=1)
        runs = _runs(ids, table.shape[0])
        ctx.save_for_backward(q, table, ids, logits, lse, *runs)
        ctx.temperature = temperature
        return torch.sum(lse - logits[:, -1]) / max(q.shape[0], 1)

    @staticmethod
    def backward(ctx, g):
        q, table, ids, logits, lse, *runs = ctx.saved_tensors
        grad = _grad(logits, lse, g, ids.shape[0], ctx.temperature).contiguous()
        dq, dtable = sampled_backward(q, table, ids, grad, *runs)
        return dq, dtable, None, None, None


@kernel_nan_check("sampled_softmax_logits (HSTU's loss)")
def sampled_logits(q, table, ids, temperature: float) -> torch.Tensor:
    m, k1 = ids.shape
    logits = torch.empty((m, k1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _check_err(_launchers()[0](q.data_ptr(), table.data_ptr(), ids.data_ptr(), m, k1,
                                   q.shape[1], 1.0 / temperature, logits.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream),
                   "sampled_softmax_logits")
    _LOGITS.launches += 1
    return logits


# entries of one item a run of dtable's first kernel (csrc/sampled_softmax.cu)
RUN = 256


def _runs(ids: torch.Tensor, r: int):
    """The entries sorted by id (stable) and cut into runs of at most RUN
    entries of one item, on the card with no host sync -> (order [N]
    int32, seg [R + 1], sub_item [S] int32 (-1 past the last run),
    sub_begin [S], sub_first [R], n_runs [R]), S an upper bound of the
    runs."""
    keys, order = torch.sort(ids.reshape(-1), stable=True)
    dev = ids.device
    seg = torch.searchsorted(keys, torch.arange(r + 1, device=dev, dtype=torch.int32))
    n_runs = (seg[1:] - seg[:-1] + RUN - 1) // RUN
    ends = torch.cumsum(n_runs, 0)
    s = torch.arange(keys.shape[0] // RUN + r + 1, device=dev)
    item = torch.searchsorted(ends, s, right=True)
    valid = item < r
    item = torch.clamp(item, max=r - 1)
    begin = seg[item] + (s - (ends[item] - n_runs[item])) * RUN
    return (order.to(torch.int32), seg, torch.where(valid, item, -1).to(torch.int32),
            begin, ends - n_runs, n_runs)


@kernel_nan_check("sampled_softmax_bwd (HSTU's loss backward)")
def sampled_backward(q, table, ids, grad, order, seg, sub_item, sub_begin, sub_first, n_runs):
    m, k1 = ids.shape
    dq, dtable = torch.empty_like(q), torch.empty_like(table)
    part = torch.empty((sub_item.shape[0], q.shape[1]), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _check_err(_launchers()[1](grad.data_ptr(), table.data_ptr(), ids.data_ptr(), m, k1,
                                   q.shape[1], dq.data_ptr(), stream), "sampled_softmax_dq")
        _check_err(_launchers()[2](grad.data_ptr(), q.data_ptr(), order.data_ptr(),
                                   seg.data_ptr(), sub_item.data_ptr(), sub_begin.data_ptr(),
                                   sub_item.shape[0], sub_first.data_ptr(), n_runs.data_ptr(),
                                   table.shape[0], k1, q.shape[1], part.data_ptr(),
                                   dtable.data_ptr(), stream), "sampled_softmax_dtable")
    _BACKWARD.launches += 1
    return dq, dtable


# the counts are kept on the functions as defined here (see embedding_bag.py),
# one a call: the backward's two kernels (dq, dtable) count once
sampled_logits.launches = 0
sampled_backward.launches = 0
_LOGITS, _BACKWARD = sampled_logits, sampled_backward


def sampled_softmax(q: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                    neg: torch.Tensor, temperature: float) -> torch.Tensor:
    """q [M, D] and table [R, D] fp32, pos [M] and neg [M, K] ids in [0, R)
    -> the mean sampled-softmax loss (see the module docstring),
    differentiable in q and table."""
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(f"sampled_softmax: want q [M, D] and table [R, D], got "
                         f"{tuple(q.shape)} and {tuple(table.shape)}")
    if pos.shape != (q.shape[0],) or neg.dim() != 2 or neg.shape[0] != q.shape[0]:
        raise ValueError("sampled_softmax: want pos [M] and neg [M, K]")
    if q.device.type == "cpu":
        return sampled_softmax_reference(q, table, pos.long(), neg.long(), temperature)
    if q.device.type != "cuda":
        raise ValueError(f"sampled_softmax: unsupported device {q.device}")
    if q.shape[1] not in WIDTHS or q.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError(f"sampled_softmax: fp32 rows of width {WIDTHS} on the card, got "
                         f"{q.dtype} D = {q.shape[1]}")
    if q.shape[0] * (neg.shape[1] + 1) >= 2**31:
        raise ValueError("sampled_softmax: M (K + 1) entries; at most 2**31 - 1")
    return SampledSoftmax.apply(q.contiguous(), table.contiguous(), pos, neg, temperature)
