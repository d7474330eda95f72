"""DeepSeekMoE's routed experts on one card's share of them (DeepSeek-V2,
arXiv:2405.04434, section 2.2): the router, the dispatch to the held
experts, the grouped GEMM of kernel row 16 (``csrc/grouped_gemm.cu``) with
its plain version, and the combine. No TPU kernel corresponds: the JAX
package has no mixture of experts; these serve ``models/mla_moe.py``.

With X experts scored and the first G of them held here (expert
parallelism: the other cards hold the rest), each token t of x [E, d]:

* routing (:func:`route`, fp32): ``s_t = softmax(x_t W_g)`` over the X
  experts, ``T_t`` its greedy top-k; the sequence-level balance loss
  ``alpha mean_b sum_e f_be P_be`` with ``f_be = X / (k n_b) #{t in b: e in
  T_t}`` and ``P_be = mean_{t in b} s_te`` (:func:`balance_loss`);
* dispatch (:func:`dispatch`): the (token, slot) pairs whose expert is
  held, sorted by expert (a stable sort), each expert's rows padded to
  whole tiles of ``PAD`` rows, all on the device: the rows are sized by a
  bound that the host knows from the batch alone (:func:`rows_bound`: every
  token on ``min(k, G)`` held experts, plus each expert's padding), and the
  kernels work only on the rows below the experts' last offset, which they
  read on the device. No host sync: the step never waits for the counts;
* the experts and the combine (:class:`RoutedExperts`): for each held
  expert e, ``SwiGLU_e(x) = (silu(x W_gate,e) * x W_up,e) W_down,e`` over
  its rows: row 16 twice forward (``W_gate`` and ``W_up`` as one product)
  and six times backward (the forward's two again, then dH, dW_down, dX and
  dW_gate_up), bf16 operands with fp32 sums, the SiLU in fp32; then
  ``y_t = sum_{k: T_tk held} s_{t,T_tk} SwiGLU_{T_tk}(x_t)``, the slots
  summed in order k = 0..top_k - 1 (no atomics: two calls give the same
  bits). What the experts of other cards would add is left out. Nothing
  bound-sized is saved for the backward: it recomputes the experts'
  forward from x (activation checkpointing).

CPU tensors take the plain versions (a loop of ``torch.matmul`` over the
groups, torch's row-wise passes); CUDA tensors launch row 16 and the
row-wise passes of ``csrc/grouped_gemm.cu`` (widths multiples of 128) or
raise. On the card the rows past the experts' last offset are never written
(they hold whatever the allocator left there) and never read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check, nan_checks_enabled
from recsys_tpu_torch.utils.trace import span

PAD = 128   # an expert's rows are padded to a multiple of this (row 16's tile)
WIDTH = 128  # the card's widths: multiples of this


class Routing(NamedTuple):
    scores: torch.Tensor    # [E, X] fp32: the softmax over every expert
    weights: torch.Tensor   # [E, k] fp32: the top-k scores (not renormalised)
    experts: torch.Tensor   # [E, k] int64: the top-k experts, by descending score


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int) -> Routing:
    """The fp32 router over x [E, d] and W_g [d, X]: the softmax and its
    greedy top-k."""
    scores = torch.softmax(torch.mm(x.float(), w_router), dim=1)
    weights, experts = torch.topk(scores, top_k, dim=1)
    return Routing(scores, weights, experts)


def balance_loss(routing: Routing, seq: torch.Tensor, histories: int,
                 alpha: float) -> torch.Tensor:
    """The sequence-level balance loss of a jagged batch (``seq`` [E]: each
    row's history), differentiable in the scores: each history's counts and
    score sums as one product of its rows' one-hot [B, E] with [hits,
    scores] [E, 2 X] (fp32 sums in a fixed order, no atomics)."""
    s = routing.scores
    n_exp, k = s.shape[1], routing.experts.shape[1]
    hits = torch.zeros_like(s).scatter_(1, routing.experts, 1.0)
    # a comparison, not an indexed store of 1.0: that copies the scalar to
    # the card from pageable memory, a sync before the shared experts are
    # queued
    member = (seq[None, :] == torch.arange(histories, device=s.device)[:, None]).to(s.dtype)
    seg = torch.mm(member, torch.cat([hits, s], dim=1))
    n = member.sum(dim=1).clamp(min=1)[:, None]
    f = seg[:, :n_exp] * (n_exp / k) / n
    return alpha * torch.mean(torch.sum(f * seg[:, n_exp:] / n, dim=1))


def rows_bound(events: int, top_k: int, held: int) -> int:
    """The padded expert rows of a batch of ``events`` tokens, from the
    host's shapes alone: each token on at most min(top_k, held) held experts,
    each expert's rows padded by under ``PAD``, rounded to whole tiles, and
    one tile more, so that the last row lies past every expert's rows."""
    bound = events * min(top_k, held) + held * (PAD - 1)
    return (bound + PAD - 1) // PAD * PAD + PAD


class Dispatch(NamedTuple):
    """The pairs (token, slot) of a batch that land on held experts, by
    expert, in ``rows`` padded rows (all on the device but ``rows``)."""
    src: torch.Tensor       # [rows] int64: each row's pair (its flat index t k + slot), -1 padding
    slot_rows: torch.Tensor  # [E, k] int64: each slot's row, or rows - 1 (past every expert's)
    offsets: torch.Tensor   # [G + 1] int32: the experts' padded rows
    counts: torch.Tensor    # [G] int64: each held expert's tokens
    rows: int               # the bound (:func:`rows_bound`), host


def dispatch(routing: Routing, held: int) -> Dispatch:
    """Sort the pairs on the ``held`` experts (0..held - 1) by expert (a
    stable sort) and give each its row of the padded expert rows, on the
    device (no host sync: the rows are :func:`rows_bound`'s)."""
    e, k = routing.experts.shape
    flat = routing.experts.reshape(-1)
    dev = flat.device
    key = torch.where(flat < held, flat, torch.full_like(flat, held))
    # a comparison a held expert, not torch.bincount: on the card that reads
    # the ids' largest value on the host
    counts = torch.sum(key[:, None] == torch.arange(held, device=dev), dim=0)
    skey, order = torch.sort(key, stable=True)
    padded = (counts + PAD - 1) // PAD * PAD
    pends = torch.cumsum(padded, 0)
    rows = rows_bound(e, k, held)
    g = torch.clamp(skey, max=held - 1)
    here = skey < held
    first = (pends - padded) - (torch.cumsum(counts, 0) - counts)
    pos = torch.arange(e * k, device=dev)
    sorted_rows = torch.where(here, first[g] + pos, torch.full_like(pos, rows - 1))
    slot_rows = torch.empty_like(sorted_rows)
    slot_rows[order] = sorted_rows
    src = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    # the pairs off this card all write -1 into the row past every expert's
    src[sorted_rows] = torch.where(here, order, torch.full_like(order, -1))
    offsets = torch.cat([torch.zeros(1, dtype=pends.dtype, device=dev), pends]).to(torch.int32)
    return Dispatch(src, slot_rows.reshape(e, k), offsets, counts, rows)


def grouped_mm_reference(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                         weights: bool = False) -> torch.Tensor:
    """Plain version of row 16 (a loop of products over the groups, the
    operands as given, multiplied in fp32): rows mode ``a`` [R, K], ``b``
    [G, N, K] -> [R, N], group g's rows of ``a`` times ``b[g]^T``; weights
    mode ``a`` [M, R], ``b`` [N, R] -> [G, M, N], group g's columns of ``a``
    times theirs of ``b``, transposed."""
    bounds = offsets.tolist()
    groups = len(bounds) - 1
    if weights:
        out = a.new_zeros((groups, a.shape[0], b.shape[0]), dtype=torch.float32)
        for g in range(groups):
            lo, hi = bounds[g], bounds[g + 1]
            out[g] = torch.matmul(a[:, lo:hi].float(), b[:, lo:hi].float().t())
        return out
    out = a.new_zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for g in range(groups):
        lo, hi = bounds[g], bounds[g + 1]
        out[lo:hi] = torch.matmul(a[lo:hi].float(), b[g].float().t())
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library().grouped_gemm
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _passes():
    lib = _build.load_library()
    gather, swiglu_, transpose = lib.moe_gather, lib.moe_swiglu, lib.moe_transpose
    gather.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
    swiglu_.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 2)
    transpose.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (gather, swiglu_, transpose):
        fn.restype = ctypes.c_int
    return gather, swiglu_, transpose


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@kernel_nan_check("grouped_gemm (the routed experts' products)")
def grouped_gemm(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                 weights: bool = False) -> torch.Tensor:
    """Row 16 on the card, bf16 operands (see :func:`grouped_mm_reference`);
    in rows mode the rows past ``offsets[-1]`` are not written (zeros while
    the NaN checks are on, which read every row)."""
    groups = offsets.shape[0] - 1
    if weights:
        m, rows, n, k = a.shape[0], a.shape[1], b.shape[0], a.shape[1]
        out = torch.empty((groups, m, n), dtype=torch.float32, device=a.device)
    else:
        rows, k, n, m = a.shape[0], a.shape[1], b.shape[1], 0
        alloc = torch.zeros if nan_checks_enabled() else torch.empty
        out = alloc((rows, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _launcher()(int(weights), a.data_ptr(), b.data_ptr(), offsets.data_ptr(), groups,
                          rows, m, n, k, out.data_ptr(), _stream(a))
    _check(err, "grouped_gemm")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
               weights: bool = False) -> torch.Tensor:
    """Row 16 of bf16 operands (CUDA: the kernel, each width a multiple of
    ``WIDTH``; CPU: the plain version)."""
    if a.device.type == "cpu":
        return grouped_mm_reference(a, b, offsets, weights)
    widths = (a.shape[0], b.shape[0]) if weights else (b.shape[1], a.shape[1])
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or any(w % WIDTH for w in widths):
        raise ValueError(f"grouped_mm: the card's kernel takes bf16 operands of widths that "
                         f"are multiples of {WIDTH}, got {a.dtype}, {b.dtype}, {widths}")
    return grouped_gemm(a.contiguous(), b.contiguous(), offsets, weights)


def gather_rows(x: torch.Tensor, disp: Dispatch, scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The expert rows [rows, d] bf16 of x [E, d] fp32: row r of a pair p
    (``disp.src``) is x's row p // k, times ``scale[p]`` where given (the
    pairs' flat [E k] gate weights), a padding row zeros; the rows past
    ``offsets[-1]`` are not written on the card (zeros on the CPU)."""
    k = disp.slot_rows.shape[1]
    if x.device.type == "cpu":
        out = torch.zeros((disp.rows, x.shape[1]), dtype=torch.bfloat16)
        src = disp.src[:int(disp.offsets[-1])]
        keep = torch.nonzero(src >= 0).reshape(-1)
        vals = x[src[keep] // k]
        if scale is not None:
            vals = scale[src[keep]][:, None] * vals
        out[keep] = vals.to(torch.bfloat16)
        return out
    x = x.float().contiguous()
    out = torch.empty((disp.rows, x.shape[1]), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _passes()[0](x.data_ptr(), x.shape[1], disp.src.data_ptr(),
                           None if scale is None else scale.contiguous().data_ptr(), k,
                           disp.offsets.data_ptr(), disp.offsets.shape[0] - 1, out.data_ptr(),
                           _stream(x))
    _check(err, "moe_gather")
    return out


def swiglu(gu: torch.Tensor, disp: Dispatch, dh: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """SwiGLU of the expert rows gu [rows, 2 I] fp32 (gate, then up): forward
    ``silu(g) u`` [rows, I] bf16; with ``dh`` [rows, I] fp32 its backward
    [rows, 2 I] bf16, ``[dh u sg (1 + g (1 - sg)), dh g sg]`` with sg =
    sigmoid(g)."""
    width = gu.shape[1] // 2
    if gu.device.type == "cpu":
        g, u = gu[:, :width], gu[:, width:]
        if dh is None:
            return (F.silu(g) * u).to(torch.bfloat16)
        sg = torch.sigmoid(g)
        return torch.cat([dh * u * sg * (1 + g * (1 - sg)), dh * g * sg],
                         dim=1).to(torch.bfloat16)
    out = torch.empty((gu.shape[0], width if dh is None else 2 * width), dtype=torch.bfloat16,
                      device=gu.device)
    with torch.cuda.device(gu.device):
        err = _passes()[1](gu.data_ptr(), None if dh is None else dh.data_ptr(), width,
                           disp.offsets.data_ptr(), disp.offsets.shape[0] - 1, out.data_ptr(),
                           _stream(gu))
    _check(err, "moe_swiglu")
    return out


def transpose_rows(a: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """a [rows, w] bf16 -> [w, rows] (row 16's weights-mode operand; on the
    card the columns past ``offsets[-1]`` are not written)."""
    if a.device.type == "cpu":
        return a.t().contiguous()
    out = torch.empty((a.shape[1], a.shape[0]), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = _passes()[2](a.data_ptr(), a.shape[1], disp.offsets.data_ptr(),
                           disp.offsets.shape[0] - 1, a.shape[0], out.data_ptr(), _stream(a))
    _check(err, "moe_transpose")
    return out


def _slots(rows: torch.Tensor, disp: Dispatch):
    """Each slot's row [E, w] of the expert rows, in slot order (a slot off
    this card reads the last row, zeroed here)."""
    rows[-1:].zero_()
    return [rows[disp.slot_rows[:, j]] for j in range(disp.slot_rows.shape[1])]


def _experts(x, w1t, w2t, disp: Dispatch):
    """The held experts' forward over their rows -> (xp, gu, hb, y)."""
    xp = gather_rows(x, disp)
    gu = grouped_mm(xp, w1t, disp.offsets)
    hb = swiglu(gu, disp)
    return xp, gu, hb, grouped_mm(hb, w2t, disp.offsets)


class RoutedExperts(torch.autograd.Function):
    """The held experts' part of the layer's output: x [E, d] fp32, gates
    [E, k] fp32, w_gate_up [G, d, 2 I] and w_down [G, I, d] fp32 -> [E, d],
    ``sum_k gates_tk SwiGLU_{T_tk}(x_t)`` over the held slots in order. It
    saves x and the weights alone; the backward recomputes the expert rows.
    The forward under ``moe.experts``, the backward (on the autograd thread)
    under ``moe.experts_bwd``."""

    @staticmethod
    def forward(ctx, x, gates, w_gate_up, w_down, disp: Dispatch):
        with span("moe.experts"):
            w1t = w_gate_up.transpose(1, 2).to(torch.bfloat16).contiguous()
            w2t = w_down.transpose(1, 2).to(torch.bfloat16).contiguous()
            y = _experts(x, w1t, w2t, disp)[3]
            slots = _slots(y, disp)
            out = gates[:, :1] * slots[0]
            for j in range(1, len(slots)):
                out = out + gates[:, j:j + 1] * slots[j]
        ctx.save_for_backward(x, gates, w_gate_up, w_down)
        ctx.disp = disp
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("moe.experts_bwd"):
            x, gates, w_gate_up, w_down = ctx.saved_tensors
            disp = ctx.disp
            w1t = w_gate_up.transpose(1, 2).to(torch.bfloat16).contiguous()
            w2t = w_down.transpose(1, 2).to(torch.bfloat16).contiguous()
            xp, gu, hb, y = _experts(x, w1t, w2t, disp)
            dgates = torch.stack([torch.sum(dout * s, dim=1) for s in _slots(y, disp)], dim=1)
            del y, w1t, w2t
            dyb = gather_rows(dout, disp, gates.reshape(-1))
            dh = grouped_mm(dyb, w_down.to(torch.bfloat16), disp.offsets)
            dgu = swiglu(gu, disp, dh)
            del gu, dh
            dw_down = grouped_mm(transpose_rows(hb, disp), transpose_rows(dyb, disp),
                                 disp.offsets, True)
            del hb, dyb
            dxp = grouped_mm(dgu, w_gate_up.to(torch.bfloat16), disp.offsets)
            dw_gate_up = grouped_mm(transpose_rows(xp, disp), transpose_rows(dgu, disp),
                                    disp.offsets, True)
            del xp, dgu
            slots = _slots(dxp, disp)
            dx = slots[0]
            for s in slots[1:]:
                dx = dx + s
        return dx, dgates, dw_gate_up, dw_down, None


def routed(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
           routing: Routing, disp: Dispatch) -> torch.Tensor:
    """The held experts' part of the layer's output [E, d] (see the module
    docstring)."""
    return RoutedExperts.apply(x, routing.weights, w_gate_up, w_down, disp)
