"""HSTU's jagged causal SiLU attention with its learned position and time
bias: the CUDA kernels of ``csrc/hstu_attention.cu`` (kernel rows 11 and
12) and their plain PyTorch versions. No TPU kernel corresponds: the JAX
package has no sequential model; these serve HSTU (``models/hstu.py``).

A batch is jagged (:class:`JaggedLayout`): the events of every sequence
end to end, sequence b in rows ``offsets[b]:offsets[b + 1]``, no padding.
Per sequence and head, with q, k, v [n, 64] its rows:

    s_ij = q_i . k_j + pos_w[j - i + N - 1] + ts_w[bucket(t'_i - t_j)]
    a_ij = silu(s_ij) / N  (j <= i, else 0);   o_i = sum_j a_ij v_j

where N is the configuration's max_sequence_length (the source divides by
it, not by n), t'_i the timestamp of event i + 1 of the sequence (the last
event's own) and :func:`bucket` the source's log bucketing. One bias is
shared by the heads. :func:`hstu_attention` takes v, q, k [events, H * 64]
fp32 and gives o [events, H * 64] fp32, with gradients for v, q, k, pos_w
and ts_w. The products take bf16 operands with fp32 sums (q, k, v, the
incoming gradient, and a and ds where they feed a product), as the kernels
do; ``bf16=False`` (the plain version only) multiplies in fp32.

CPU tensors take :func:`attention_reference` (a sequence at a time, the
scores materialised); CUDA tensors launch the kernels (at most
``MAX_HEADS`` heads) or raise. The forward and row 12's dK/dV kernel
compute the bias once a (query tile, key tile) pair for every head. The
kernels write no [n, n] tensor, and sum dp and dw through per-block
partials in a fixed order: two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check
from recsys_tpu_torch.utils.trace import span

HEAD_DIM = 64        # dqk = dv, the kernels' only width
TILE = 64            # rows of a query or key tile of the kernels
MAX_HEADS = 4        # the kernels' heads: a warpgroup a head (row 12's dQ kernel: two)
NUM_BUCKETS = 128    # time buckets; ts_w has NUM_BUCKETS + 1 entries
# a bucket's width in log seconds is the source's 0.301; its log is
# multiplied by the fp32 reciprocal, as PyTorch divides a tensor by a
# scalar on the card, so the bucket is the same on either device and in
# the kernels
INV_BUCKET_BASE = float(np.float32(1.0) / np.float32(0.301))


class JaggedLayout(NamedTuple):
    """A jagged batch's layout, on one device. ``events``, ``pairs`` (the
    causal pairs, sum n (n + 1) / 2), ``max_len`` and ``tile_pairs`` (the
    causal (query tile, key tile) pairs of the kernels, sum T (T + 1) / 2
    over T = ceil(n / TILE)) are host numbers."""
    offsets: torch.Tensor    # [B + 1] int32
    positions: torch.Tensor  # [events] int64: each event's index in its sequence
    seq: torch.Tensor        # [events] int64: each event's sequence
    q_tiles: torch.Tensor    # [slots, 2] int32: (sequence, query tile), longest sweeps first
    k_tiles: torch.Tensor    # [slots, 2] int32: (sequence, key tile), longest sweeps first
    events: int
    pairs: int
    max_len: int
    tile_pairs: int


def _tiles(lengths: torch.Tensor, slots: int, key: bool) -> torch.Tensor:
    """[slots, 2] int32 (sequence, tile) of every tile of sequences of
    ``lengths``, the tiles with the most tiles to sweep first; (-1, 0)
    past the last tile. A query tile i sweeps i + 1 key tiles, a key tile
    j the sequence's tiles from j on."""
    n_tiles = (lengths + TILE - 1) // TILE
    cum = torch.cumsum(n_tiles, 0)
    s = torch.arange(slots, device=lengths.device)
    b = torch.clamp(torch.searchsorted(cum, s, right=True), max=lengths.shape[0] - 1)
    t = s - (cum[b] - n_tiles[b])
    valid = s < cum[-1]
    work = torch.where(valid, n_tiles[b] - t if key else t + 1, torch.zeros_like(t))
    order = torch.sort(-work, stable=True).indices
    out = torch.stack([torch.where(valid, b, -1), torch.where(valid, t, 0)], 1)[order]
    return out.to(torch.int32).contiguous()


def on_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a CPU tensor bound for the card goes through
    pinned memory, so that the copy does not wait for the card's queue (a
    copy from pageable memory does)."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_layout(lengths: torch.Tensor, device=None) -> JaggedLayout:
    """The layout of sequences of ``lengths`` [B] (any device; a CPU tensor
    costs no host sync), placed on ``device`` (default: ``lengths``')."""
    device = torch.device(device) if device is not None else lengths.device
    host = lengths.detach().to("cpu", torch.int64)
    events = int(host.sum())
    pairs = int((host * (host + 1) // 2).sum())
    max_len = int(host.max()) if host.numel() else 0
    n_tiles = (host + TILE - 1) // TILE
    tile_pairs = int((n_tiles * (n_tiles + 1) // 2).sum())
    lens = on_device(lengths.to(torch.int64), device)
    offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lens, 0)
    seq = torch.repeat_interleave(torch.arange(lens.shape[0], device=device), lens,
                                  output_size=events)
    positions = torch.arange(events, device=device) - offsets[seq]
    slots = events // TILE + lens.shape[0]  # at least sum ceil(n / TILE)
    return JaggedLayout(offsets.to(torch.int32), positions, seq, _tiles(lens, slots, False),
                        _tiles(lens, slots, True), events, pairs, max_len, tile_pairs)


def bucket(dt: torch.Tensor) -> torch.Tensor:
    """The source's time buckets of int64 gaps:
    ``min(128, (int)(log(max(|dt|, 1)) / 0.301))`` in fp32, the division
    taken as the product by fp32(1 / 0.301)."""
    x = torch.log(torch.abs(dt).clamp(min=1).to(torch.float32)) * INV_BUCKET_BASE
    return x.to(torch.int64).clamp(0, NUM_BUCKETS)


def next_timestamps(timestamps: torch.Tensor, layout: JaggedLayout) -> torch.Tensor:
    """t' [events]: each event's next event's timestamp in its sequence,
    the last event's own."""
    e = torch.arange(layout.events, device=timestamps.device)
    last = layout.offsets.to(torch.int64)[layout.seq + 1] - 1
    return timestamps[torch.minimum(e + 1, last)]


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def _sequence_bias(pos_w, ts_w, ts, ts_next, n_max):
    """A sequence's [n, n] bias, its buckets and index of pos_w."""
    n = ts.shape[0]
    i = torch.arange(n, device=ts.device)
    rel = i[None, :] - i[:, None] + n_max - 1
    bk = bucket(ts_next[:, None] - ts[None, :])
    return pos_w[rel] + ts_w[bk], rel, bk


class _AttentionReference(torch.autograd.Function):
    """The plain version of rows 11 and 12, a sequence at a time."""

    @staticmethod
    def forward(ctx, v, q, k, pos_w, ts_w, timestamps, layout, n_max, heads, bf16):
        ts_next = next_timestamps(timestamps, layout)
        out = torch.zeros_like(q)
        bounds = layout.offsets.tolist()
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if b1 == b0:
                continue
            n = b1 - b0
            qh, kh, vh = (_round(t[b0:b1], bf16).reshape(n, heads, HEAD_DIM).transpose(0, 1)
                          for t in (q, k, v))
            bias = _sequence_bias(pos_w, ts_w, timestamps[b0:b1], ts_next[b0:b1], n_max)[0]
            x = qh @ kh.transpose(1, 2) + bias
            a = torch.tril(torch.nn.functional.silu(x) / n_max)
            out[b0:b1] = (_round(a, bf16) @ vh).transpose(0, 1).reshape(n, -1)
        ctx.save_for_backward(v, q, k, pos_w, ts_w, timestamps)
        ctx.layout, ctx.n_max, ctx.heads, ctx.bf16 = layout, n_max, heads, bf16
        return out

    @staticmethod
    def backward(ctx, g):
        v, q, k, pos_w, ts_w, timestamps = ctx.saved_tensors
        layout, n_max, heads, bf16 = ctx.layout, ctx.n_max, ctx.heads, ctx.bf16
        ts_next = next_timestamps(timestamps, layout)
        dv, dq, dk = torch.zeros_like(v), torch.zeros_like(q), torch.zeros_like(k)
        dp, dw = torch.zeros_like(pos_w), torch.zeros_like(ts_w)
        bounds = layout.offsets.tolist()
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if b1 == b0:
                continue
            n = b1 - b0
            qh, kh, vh, gh = (_round(t[b0:b1], bf16).reshape(n, heads, HEAD_DIM).transpose(0, 1)
                              for t in (q, k, v, g))
            bias, rel, bk = _sequence_bias(pos_w, ts_w, timestamps[b0:b1], ts_next[b0:b1],
                                           n_max)
            x = qh @ kh.transpose(1, 2) + bias
            sg = torch.sigmoid(x)
            mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))
            a = torch.where(mask, x * sg / n_max, 0.0)
            da = gh @ vh.transpose(1, 2)
            ds = torch.where(mask, da * sg * (1 + x * (1 - sg)) / n_max, 0.0)
            dsr = _round(ds, bf16)
            dv[b0:b1] = (_round(a, bf16).transpose(1, 2) @ gh).transpose(0, 1).reshape(n, -1)
            dq[b0:b1] = (dsr @ kh).transpose(0, 1).reshape(n, -1)
            dk[b0:b1] = (dsr.transpose(1, 2) @ qh).transpose(0, 1).reshape(n, -1)
            dsum = ds.sum(0)
            dp.index_add_(0, rel[mask], dsum[mask])
            dw.index_add_(0, bk[mask], dsum[mask])
        return dv, dq, dk, dp, dw, None, None, None, None, None


def attention_reference(v, q, k, pos_w, ts_w, timestamps, layout: JaggedLayout, n_max: int,
                        bf16: bool = True) -> torch.Tensor:
    """Plain version of rows 11 and 12: the forward, and its backward
    through autograd (the kernels' arithmetic, a sequence at a time, the
    [H, n, n] scores materialised). Any device."""
    heads = q.shape[1] // HEAD_DIM
    return _AttentionReference.apply(v, q, k, pos_w, ts_w, timestamps, layout, n_max, heads,
                                     bf16)


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().hstu_attn_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().hstu_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn


def attention_fwd_cuda(qkv: torch.Tensor, pos_w, ts_w, timestamps, layout: JaggedLayout,
                       n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 11: qkv [events, 3 H 64] bf16 (v, q, k) -> (o [events, H 64] fp32,
    the bias values each block computed [slots] int32)."""
    heads = qkv.shape[1] // (3 * HEAD_DIM)
    slots = layout.q_tiles.shape[0]
    out = torch.empty((layout.events, heads * HEAD_DIM), dtype=torch.float32,
                      device=qkv.device)
    counts = torch.empty(slots, dtype=torch.int32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _fwd_launcher()(qkv.data_ptr(), layout.q_tiles.data_ptr(), slots,
                              layout.offsets.data_ptr(), timestamps.data_ptr(),
                              pos_w.data_ptr(), ts_w.data_ptr(), layout.events, heads, n_max,
                              out.data_ptr(), counts.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hstu_attn_fwd kernel launch failed: cudaError {err}")
    return out, counts


def attention_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, pos_w, ts_w, timestamps,
                       layout: JaggedLayout, n_max: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row 12: -> (dqkv [events, 3 H 64] fp32 in qkv's columns, dpos_w, dts_w,
    the bias values each block of the dK/dV kernel computed [slots] int32)."""
    dev = qkv.device
    slots = layout.q_tiles.shape[0]
    dqkv = torch.empty(qkv.shape, dtype=torch.float32, device=dev)
    dp_part = torch.empty((slots, n_max), dtype=torch.float32, device=dev)
    dw_part = torch.empty((slots, NUM_BUCKETS + 1), dtype=torch.float32, device=dev)
    dp = torch.empty_like(pos_w)
    dw = torch.empty_like(ts_w)
    counts = torch.empty(slots, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _bwd_launcher()(qkv.data_ptr(), dout.data_ptr(), layout.q_tiles.data_ptr(),
                              layout.k_tiles.data_ptr(), slots, layout.offsets.data_ptr(),
                              timestamps.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(),
                              layout.events, qkv.shape[1] // (3 * HEAD_DIM), n_max,
                              dqkv.data_ptr(), dp_part.data_ptr(), dw_part.data_ptr(),
                              dp.data_ptr(), dw.data_ptr(), counts.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hstu_attn_bwd kernel launch failed: cudaError {err}")
    return dqkv, dp, dw, counts


class HstuAttention(torch.autograd.Function):
    """Rows 11 and 12 on the card: the forward under the span ``hstu.attn``,
    the backward (on the autograd thread) under ``hstu.attn_bwd``."""

    @staticmethod
    def forward(ctx, v, q, k, pos_w, ts_w, timestamps, layout, n_max):
        with span("hstu.attn"):
            w = q.shape[1]
            qkv = torch.empty((q.shape[0], 3 * w), dtype=torch.bfloat16, device=q.device)
            for i, t in enumerate((v, q, k)):
                qkv[:, i * w:(i + 1) * w].copy_(t)
            pos_w, ts_w = pos_w.detach().contiguous(), ts_w.detach().contiguous()
            out = hstu_attn_fwd(qkv, pos_w, ts_w, timestamps, layout, n_max)
        ctx.save_for_backward(qkv, pos_w, ts_w, timestamps)
        ctx.layout, ctx.n_max = layout, n_max
        return out

    @staticmethod
    def backward(ctx, g):
        with span("hstu.attn_bwd"):
            qkv, pos_w, ts_w, timestamps = ctx.saved_tensors
            dqkv, dp, dw = hstu_attn_bwd(qkv, g.to(torch.bfloat16).contiguous(), pos_w, ts_w,
                                         timestamps, ctx.layout, ctx.n_max)
            dv, dq, dk = dqkv.chunk(3, dim=1)
        return dv, dq, dk, dp, dw, None, None, None


@kernel_nan_check("hstu_attn_fwd (HSTU's attention forward)")
def hstu_attn_fwd(qkv, pos_w, ts_w, timestamps, layout, n_max):
    out, _FWD.bias_counts = attention_fwd_cuda(qkv, pos_w, ts_w, timestamps, layout, n_max)
    _FWD.launches += 1
    return out


@kernel_nan_check("hstu_attn_bwd (HSTU's attention backward)")
def hstu_attn_bwd(qkv, dout, pos_w, ts_w, timestamps, layout, n_max):
    dqkv, dp, dw, _BWD.bias_counts = attention_bwd_cuda(qkv, dout, pos_w, ts_w, timestamps,
                                                         layout, n_max)
    _BWD.launches += 1
    return dqkv, dp, dw


# launches, and bias_counts: the bias values that each block of the last
# call's forward kernel (row 12: its dK/dV kernel; the dQ kernel is not
# counted) computed, a device tensor [slots] int32 that the kernel writes, a
# plain store a block. Its sum is TILE^2 a (query tile, key tile) pair where
# the bias is computed once a pair for every head, and H times that where
# once a head. The counts are kept on the functions as defined here (see
# embedding_bag.py)
hstu_attn_fwd.launches = hstu_attn_bwd.launches = 0
hstu_attn_fwd.bias_counts = hstu_attn_bwd.bias_counts = None
_FWD, _BWD = hstu_attn_fwd, hstu_attn_bwd


def _check(v, q, k, pos_w, ts_w, timestamps, layout: JaggedLayout, n_max: int) -> None:
    width = q.shape[1] if q.dim() == 2 else -1
    for name, t in (("v", v), ("k", k)):
        if t.shape != q.shape:
            raise ValueError(f"hstu_attention: {name} is {tuple(t.shape)}, q {tuple(q.shape)}")
    if width <= 0 or width % HEAD_DIM or q.shape[0] != layout.events:
        raise ValueError(f"hstu_attention: want q, k, v [{layout.events}, H * {HEAD_DIM}], "
                         f"got {tuple(q.shape)}")
    if pos_w.shape != (2 * n_max - 1,) or ts_w.shape != (NUM_BUCKETS + 1,):
        raise ValueError(f"hstu_attention: want pos_w [{2 * n_max - 1}] and ts_w "
                         f"[{NUM_BUCKETS + 1}], got {tuple(pos_w.shape)}, {tuple(ts_w.shape)}")
    if timestamps.dtype != torch.int64 or timestamps.shape != (layout.events,):
        raise ValueError("hstu_attention: want int64 timestamps [events]")
    if layout.max_len > n_max:
        raise ValueError(f"hstu_attention: a sequence of {layout.max_len} events; the "
                         f"configuration's max_sequence_length is {n_max}")


def hstu_attention(v: torch.Tensor, q: torch.Tensor, k: torch.Tensor, pos_w: torch.Tensor,
                   ts_w: torch.Tensor, timestamps: torch.Tensor, layout: JaggedLayout,
                   n_max: int, bf16: bool = True) -> torch.Tensor:
    """o [events, H 64] fp32 of v, q, k [events, H 64] fp32 (see the module
    docstring), differentiable in v, q, k, pos_w and ts_w. CPU tensors take
    :func:`attention_reference` (``bf16`` as given); CUDA tensors the
    kernels (bf16 operands and H <= MAX_HEADS only: else it raises) or
    raise."""
    _check(v, q, k, pos_w, ts_w, timestamps, layout, n_max)
    if q.device.type != "cpu" and not bf16:
        raise ValueError("hstu_attention: the card's kernels take bf16 operands only; fp32 "
                         "operands run on the CPU alone")
    if q.device.type != "cpu" and q.shape[1] > MAX_HEADS * HEAD_DIM:
        raise ValueError(f"hstu_attention: the card's kernels take at most {MAX_HEADS} heads "
                         f"(a warpgroup a head), got {q.shape[1] // HEAD_DIM}; more run on "
                         "the CPU alone")
    if q.device.type == "cpu":
        with span("hstu.attn"):
            return attention_reference(v, q, k, pos_w, ts_w, timestamps, layout, n_max, bf16)
    if q.device.type != "cuda":
        raise ValueError(f"hstu_attention: unsupported device {q.device}")
    return HstuAttention.apply(v, q, k, pos_w, ts_w, timestamps, layout, n_max)

