"""MLA's jagged causal softmax attention (DeepSeek-V2, arXiv:2405.04434,
section 2.1): the CUDA kernels of ``csrc/mla_attention.cu`` (kernel rows
14 and 15) and their plain PyTorch versions. No TPU kernel corresponds: the
JAX package has no sequential model; these serve ``models/mla_moe.py``.

A batch is jagged (``ops/hstu_attention.py::JaggedLayout``: the events of
every sequence end to end, no padding). Per sequence and head, with q, k
[n, DQK] and v [n, DV] its rows (DQK = 192: 128 nope + 64 rope columns;
DV = 128 on the card):

    p_ij = softmax_j(tau q_i . k_j)  over j <= i;   o_i = sum_j p_ij v_j

The forward also gives each row's logsumexp in log2 units, ``lse_i =
log2 sum_{j <= i} 2^(c q_i . k_j)`` with c = tau log2(e), which the
backward takes with ``delta_i = do_i . o_i`` to recompute the
probabilities: ``p_ij = 2^(c q_i . k_j - lse_i)``, ``ds_ij = tau p_ij
(do_i . v_j - delta_i)``, ``dq_i = sum_j ds_ij k_j``, ``dk_j = sum_i ds_ij
q_i``, ``dv_j = sum_i p_ij do_i``. The products take bf16 operands with
fp32 sums (q, k, v, do, and p and ds where they feed a product); the
softmax statistics are fp32.

:func:`mla_attention` takes q, k [events, H * DQK] and v [events, H * DV]
fp32 and gives o [events, H * DV] fp32, differentiable in q, k and v. CPU
tensors take :func:`attention_reference` (a sequence at a time, the scores
materialised; ``bf16=False`` multiplies in fp32); CUDA tensors launch the
kernels (DQK 192, DV 128, bf16 operands) or raise. The kernels write no
[n, n] tensor and use no atomics: every output row is written by one block,
so two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.hstu_attention import JaggedLayout
from recsys_tpu_torch.utils.debug import kernel_nan_check
from recsys_tpu_torch.utils.trace import span

DQK = 192   # the kernels' query-key width a head (128 nope + 64 rope)
DV = 128    # and value width
LOG2E = 1.4426950408889634


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def _heads(x: torch.Tensor, heads: int, bf16: bool) -> torch.Tensor:
    """[n, H w] -> [H, n, w], rounded to bf16 under ``bf16``."""
    n = x.shape[0]
    return _round(x, bf16).reshape(n, heads, -1).transpose(0, 1)


class _AttentionReference(torch.autograd.Function):
    """The plain version of rows 14 and 15, a sequence at a time."""

    @staticmethod
    def forward(ctx, q, k, v, layout, heads, scale, bf16):
        out = torch.zeros((q.shape[0], v.shape[1]), dtype=torch.float32, device=q.device)
        lse = torch.zeros((q.shape[0], heads), dtype=torch.float32, device=q.device)
        c = scale * LOG2E
        bounds = layout.offsets.tolist()
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if b1 == b0:
                continue
            n = b1 - b0
            qh, kh, vh = (_heads(t[b0:b1], heads, bf16) for t in (q, k, v))
            x = (qh @ kh.transpose(1, 2)) * c
            x = x.masked_fill(~torch.tril(torch.ones(n, n, dtype=torch.bool,
                                                     device=q.device)), -math.inf)
            m = x.amax(dim=2, keepdim=True)
            p = torch.exp2(x - m)
            ell = p.sum(dim=2, keepdim=True)
            o = (_round(p, bf16) @ vh) / ell
            out[b0:b1] = o.transpose(0, 1).reshape(n, -1)
            lse[b0:b1] = (m + torch.log2(ell))[:, :, 0].t()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout, ctx.heads, ctx.scale, ctx.bf16 = layout, heads, scale, bf16
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _glse):
        q, k, v, out, lse = ctx.saved_tensors
        heads, scale, bf16 = ctx.heads, ctx.scale, ctx.bf16
        c = scale * LOG2E
        delta = (g * out).reshape(g.shape[0], heads, -1).sum(dim=2)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        bounds = ctx.layout.offsets.tolist()
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if b1 == b0:
                continue
            n = b1 - b0
            qh, kh, vh, gh = (_heads(t[b0:b1], heads, bf16) for t in (q, k, v, g))
            mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=q.device))
            x = (qh @ kh.transpose(1, 2)) * c
            p = torch.where(mask, torch.exp2(x - lse[b0:b1].t()[:, :, None]), 0.0)
            dp = gh @ vh.transpose(1, 2)
            ds = _round(scale * p * (dp - delta[b0:b1].t()[:, :, None]), bf16)
            dv[b0:b1] = (_round(p, bf16).transpose(1, 2) @ gh).transpose(0, 1).reshape(n, -1)
            dq[b0:b1] = (ds @ kh).transpose(0, 1).reshape(n, -1)
            dk[b0:b1] = (ds.transpose(1, 2) @ qh).transpose(0, 1).reshape(n, -1)
        return dq, dk, dv, None, None, None, None


def attention_reference(q, k, v, layout: JaggedLayout, heads: int, scale: float,
                        bf16: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of rows 14 and 15 -> (o [events, H DV], lse [events, H]
    in log2 units): the kernels' arithmetic, a sequence at a time, the [H,
    n, n] scores materialised; the backward through autograd. Any device."""
    return _AttentionReference.apply(q, k, v, layout, heads, scale, bf16)


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().mla_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().mla_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def attention_fwd_cuda(q, k, v, layout: JaggedLayout, heads: int,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 14: q, k [events, H 192], v [events, H 128] bf16 -> (o [events, H
    128] fp32, lse [events, H] fp32, log2 units)."""
    slots = layout.q_tiles.shape[0]
    out = torch.empty((layout.events, heads * DV), dtype=torch.float32, device=q.device)
    lse = torch.empty((layout.events, heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), layout.q_tiles.data_ptr(),
                              slots, layout.offsets.data_ptr(), layout.events, heads,
                              scale * LOG2E, out.data_ptr(), lse.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_attn_fwd kernel launch failed: cudaError {err}")
    return out, lse


def attention_bwd_cuda(q, k, v, dout, lse, delta, layout: JaggedLayout, heads: int,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row 15: dout [events, H 128] bf16, lse and delta [events, H] fp32 ->
    (dq, dk [events, H 192], dv [events, H 128]) fp32."""
    slots = layout.q_tiles.shape[0]
    dq = torch.empty((layout.events, heads * DQK), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty((layout.events, heads * DV), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                              lse.data_ptr(), delta.data_ptr(), layout.q_tiles.data_ptr(),
                              layout.k_tiles.data_ptr(), slots, layout.offsets.data_ptr(),
                              layout.events, heads, scale * LOG2E, scale, dq.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_attn_bwd kernel launch failed: cudaError {err}")
    return dq, dk, dv


@kernel_nan_check("mla_attn_fwd (MLA's attention forward)")
def mla_attn_fwd(q, k, v, layout, heads, scale):
    out = attention_fwd_cuda(q, k, v, layout, heads, scale)
    _FWD.launches += 1
    return out


@kernel_nan_check("mla_attn_bwd (MLA's attention backward)")
def mla_attn_bwd(q, k, v, dout, lse, delta, layout, heads, scale):
    out = attention_bwd_cuda(q, k, v, dout, lse, delta, layout, heads, scale)
    _BWD.launches += 1
    return out


# launches, kept on the functions as defined here (see embedding_bag.py)
mla_attn_fwd.launches = mla_attn_bwd.launches = 0
_FWD, _BWD = mla_attn_fwd, mla_attn_bwd


class MlaAttention(torch.autograd.Function):
    """Rows 14 and 15 on the card: the forward copies q, k and v to bf16
    and launches row 14; the backward (on the autograd thread, under the
    span ``mla.attn_bwd``) takes delta = rowsum(do o) and launches row 15."""

    @staticmethod
    def forward(ctx, q, k, v, layout, heads, scale):
        qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
        out, lse = mla_attn_fwd(qb, kb, vb, layout, heads, scale)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.layout, ctx.heads, ctx.scale = layout, heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        with span("mla.attn_bwd"):
            qb, kb, vb, out, lse = ctx.saved_tensors
            g = g.contiguous()
            delta = (g * out).reshape(g.shape[0], ctx.heads, DV).sum(dim=2)
            dq, dk, dv = mla_attn_bwd(qb, kb, vb, g.to(torch.bfloat16), lse, delta, ctx.layout,
                                      ctx.heads, ctx.scale)
        return dq, dk, dv, None, None, None


def _check(q, k, v, layout: JaggedLayout, heads: int) -> None:
    if q.dim() != 2 or k.shape != q.shape or v.dim() != 2 or v.shape[0] != q.shape[0]:
        raise ValueError(f"mla_attention: want q, k [events, H dqk] and v [events, H dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != layout.events or q.shape[1] % heads or v.shape[1] % heads:
        raise ValueError(f"mla_attention: {layout.events} events of {heads} heads, got "
                         f"q {tuple(q.shape)} and v {tuple(v.shape)}")


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout: JaggedLayout,
                  heads: int, scale: float, bf16: bool = True) -> torch.Tensor:
    """o [events, H dv] fp32 of q, k [events, H dqk] and v [events, H dv]
    fp32 (see the module docstring), differentiable in q, k and v. CPU
    tensors take :func:`attention_reference` (``bf16`` as given); CUDA
    tensors the kernels (dqk 192, dv 128 and bf16 operands only: else it
    raises)."""
    _check(q, k, v, layout, heads)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, layout, heads, scale, bf16)[0]
    if not bf16 or q.shape[1] != heads * DQK or v.shape[1] != heads * DV:
        raise ValueError(f"mla_attention: the card's kernels take bf16 operands of heads "
                         f"{DQK} (q, k) and {DV} (v) wide, got {q.shape[1] // heads} and "
                         f"{v.shape[1] // heads}; other widths run on the CPU alone")
    if q.device.type != "cuda":
        raise ValueError(f"mla_attention: unsupported device {q.device}")
    return MlaAttention.apply(q, k, v, layout, heads, scale)
