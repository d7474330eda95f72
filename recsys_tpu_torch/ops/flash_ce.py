"""Flash in-batch softmax cross-entropy: the CUDA kernels of
``csrc/flash_ce.cu`` (forward and fused backward) and their plain PyTorch
versions (the port of ``recsys_tpu/ops/pallas/flash_ce.py``).

Per query row ``i`` of ``u [Bq, D]`` against candidates ``v [Bk, D]``::

    ce_i = logsumexp_j(s_ij) - s_{i,pos_i},  s_ij = u_i . v_j + colcorr_j,

with accidental hits (``ids_q[i] == ids_k[j]`` and ``j != pos_i``) set to
-1e9. ``colcorr = item_bias - log_q`` per candidate column. The kernels
never write the [Bq, Bk] logits; the plain versions (``*_reference``)
do, and run only for CPU tensors.

What differs from the TPU kernels: the tiles need not divide the batch
(ragged rows and candidates are masked), and the two-kernel backward
(``_bwd_du_kernel`` / ``_bwd_dv_kernel``, which the TPU package takes
when its dU partials exceed ``_FUSED_BWD_PARTIALS_CAP``) is not ported
yet: past that point the backward raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from recsys_tpu_torch.ops import _build

NEG_BIG = -1e9
# tile sizes of csrc/flash_ce.cu (query rows, candidate rows per tile)
TQ = 64
TK = 64
MAX_DIM = 256
# The TPU package's fused backward keeps one dU partial per 2,048-wide
# candidate tile; above this many bytes of them ([ceil(Bk / 2048), Bq, D]
# fp32) it switches to its two-kernel backward, and the port raises there
# instead (kernel rows 6 and 7, ROADMAP Queue 2): at D = 128 the square
# batch reaches it above ~139k rows. The port's own partials never exceed
# the cap either (bwd_tiles_per_block). The value is the JAX package's,
# set from a TPU v5e measurement: unmeasured on H100.
_FUSED_BWD_PARTIALS_CAP = int(4.5 * 1024**3)
_TPU_TK = 2048


def _masked_logits(u, v, colcorr, ids_q, ids_k, pos):
    """The full [Bq, Bk] fp32 logits of the kernels' contract: fp32
    products of the (bf16 or fp32) operands, + colcorr, accidental -1e9."""
    s = torch.matmul(u.float(), v.float().T) + colcorr[None, :]
    col = torch.arange(v.shape[0], device=v.device)
    accidental = (ids_q[:, None] == ids_k[None, :]) & (col[None, :] != pos[:, None])
    return torch.where(accidental, torch.full_like(s, NEG_BIG), s)


def flash_ce_fwd_reference(u, v, colcorr, ids_q, ids_k, pos
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (``_dense_ref_fwd``):
    -> (lse [Bq], positive logit [Bq]), fp32."""
    s = _masked_logits(u, v, colcorr, ids_q, ids_k, pos)
    lse = torch.logsumexp(s, dim=-1)
    return lse, torch.gather(s, 1, pos.long()[:, None])[:, 0]


def flash_ce_bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused backward kernel (the softmax part, before
    the label terms): -> (dU [Bq, D], dV [Bk, D], dcol [Bk]), fp32. As in
    the kernel, dcol sums the fp32 ``p*g`` and both products take ``p*g``
    rounded to the operand type."""
    s = _masked_logits(u, v, colcorr, ids_q, ids_k, pos)
    pg32 = torch.exp(s - lse[:, None]) * g[:, None]
    pg = pg32.to(u.dtype).float()
    return pg @ v.float(), pg.T @ u.float(), pg32.sum(dim=0)


def _check(u, v, colcorr, ids_q, ids_k, pos, what: str) -> None:
    if u.dim() != 2 or v.dim() != 2 or v.shape[1] != u.shape[1]:
        raise ValueError(f"{what}: want u [Bq, D], v [Bk, D]; got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    bq, d = u.shape
    bk = v.shape[0]
    if bq == 0 or bk == 0 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"{what}: want Bq, Bk >= 1 and 1 <= D <= {MAX_DIM}; got "
                         f"{bq}, {bk}, {d}")
    if u.dtype != v.dtype or u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: u and v must both be fp32 or both bf16, got "
                         f"{u.dtype}, {v.dtype}")
    for name, t, n, dtype in (("colcorr", colcorr, bk, torch.float32),
                              ("ids_q", ids_q, bq, torch.int32),
                              ("ids_k", ids_k, bk, torch.int32),
                              ("pos", pos, bq, torch.int32)):
        if t.shape != (n,) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("u", u), ("v", v), ("colcorr", colcorr), ("ids_q", ids_q),
                    ("ids_k", ids_k), ("pos", pos)):
        if t.device != u.device:
            raise ValueError(f"{what}: {name} on {t.device}, u on {u.device}")


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().flash_ce_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().flash_ce_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(u, what: str) -> bool:
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {u.device}")
    return True


def flash_ce_fwd(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                 ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (lse [Bq], positive logit [Bq]) fp32. ``u``, ``v`` fp32 or bf16,
    ``colcorr`` fp32 [Bk], ids and ``pos`` int32.

    CPU tensors take :func:`flash_ce_fwd_reference`; CUDA tensors launch
    the kernel or raise."""
    _check(u, v, colcorr, ids_q, ids_k, pos, "flash_ce_fwd")
    if not _on_cuda(u, "flash_ce_fwd"):
        return flash_ce_fwd_reference(u, v, colcorr, ids_q, ids_k, pos)
    bq, d = u.shape
    bk = v.shape[0]
    u, v = u.contiguous(), v.contiguous()
    colcorr, ids_q, ids_k, pos = (t.contiguous() for t in (colcorr, ids_q, ids_k, pos))
    lse = torch.empty((bq,), dtype=torch.float32, device=u.device)
    pos_logit = torch.empty_like(lse)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_launcher()(u.data_ptr(), v.data_ptr(), colcorr.data_ptr(),
                              ids_q.data_ptr(), ids_k.data_ptr(), pos.data_ptr(),
                              bq, bk, d, int(u.dtype == torch.bfloat16),
                              lse.data_ptr(), pos_logit.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_fwd kernel launch failed: cudaError {err}")
    flash_ce_fwd.launches += 1
    return lse, pos_logit


flash_ce_fwd.launches = 0


def fused_bwd_partials_bytes(bq: int, bk: int, d: int) -> int:
    """Bytes of dU partials the TPU's fused backward keeps: what
    ``_FUSED_BWD_PARTIALS_CAP`` bounds."""
    return bq * d * (-(-bk // _TPU_TK)) * 4


def bwd_tiles_per_block(bq: int, bk: int, d: int) -> int:
    """Candidate tiles (of ``TK``) that one backward block sweeps: 1 (a
    block per tile, the most parallel) while the ``[ceil(Bk / TK), Bq, D]``
    fp32 partials fit under ``_FUSED_BWD_PARTIALS_CAP``, else the fewest
    that keep the kernel's ``[n_blocks, Bq, D]`` partials under it."""
    n_tiles = -(-bk // TK)
    max_parts = max(1, _FUSED_BWD_PARTIALS_CAP // (bq * d * 4))
    return -(-n_tiles // min(n_tiles, max_parts))


def flash_ce_bwd(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                 ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax part of the backward (before the label terms) -> (dU [Bq, D],
    dV [Bk, D], dcol [Bk]) fp32; ``lse`` and ``g`` fp32 [Bq].

    CPU tensors take :func:`flash_ce_bwd_reference`; CUDA tensors launch
    the fused kernel (one sweep, dU partials summed here with
    ``torch.sum``) or raise. Where the TPU package's partials pass the
    cap, both raise."""
    _check(u, v, colcorr, ids_q, ids_k, pos, "flash_ce_bwd")
    bq, d = u.shape
    bk = v.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (bq,) or t.dtype != torch.float32 or t.device != u.device:
            raise ValueError(f"flash_ce_bwd: {name} must be fp32 [{bq}] on {u.device}")
    # the same contract on both devices: past the cap, raise
    part_bytes = fused_bwd_partials_bytes(bq, bk, d)
    if part_bytes > _FUSED_BWD_PARTIALS_CAP:
        raise NotImplementedError(
            f"flash_ce_bwd: {part_bytes} bytes of dU partials exceed "
            f"_FUSED_BWD_PARTIALS_CAP; the two-kernel backward (kernel table rows "
            f"6 and 7, flash_ce.py:188 and :218) is not ported yet (ROADMAP Queue 2)")
    if not _on_cuda(u, "flash_ce_bwd"):
        return flash_ce_bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g)
    u, v = u.contiguous(), v.contiguous()
    colcorr, ids_q, ids_k, pos, lse, g = (
        t.contiguous() for t in (colcorr, ids_q, ids_k, pos, lse, g))
    dv = torch.empty((bk, d), dtype=torch.float32, device=u.device)
    dcol = torch.empty((bk,), dtype=torch.float32, device=u.device)
    tiles_per_block = bwd_tiles_per_block(bq, bk, d)
    n_tiles = -(-bk // TK)
    n_blocks = -(-n_tiles // tiles_per_block)
    du_part = torch.empty((n_blocks, bq, d), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(u.data_ptr(), v.data_ptr(), colcorr.data_ptr(),
                              ids_q.data_ptr(), ids_k.data_ptr(), pos.data_ptr(),
                              lse.data_ptr(), g.data_ptr(), bq, bk, d,
                              int(u.dtype == torch.bfloat16), tiles_per_block,
                              dv.data_ptr(), dcol.data_ptr(), du_part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_bwd kernel launch failed: cudaError {err}")
    flash_ce_bwd.launches += 1
    return torch.sum(du_part, dim=0), dv, dcol


flash_ce_bwd.launches = 0


class FlashSoftmaxCE(torch.autograd.Function):
    """Per-row CE [Bq] = lse_i - s_{i,pos_i}, differentiable w.r.t. u, v
    and colcorr (the JAX package's ``flash_softmax_ce`` custom_vjp)."""

    @staticmethod
    def forward(ctx, u, v, colcorr, ids_q, ids_k, pos):
        lse, pos_logit = flash_ce_fwd(u, v, colcorr, ids_q, ids_k, pos)
        ctx.save_for_backward(u, v, colcorr, ids_q, ids_k, pos, lse)
        return lse - pos_logit

    @staticmethod
    def backward(ctx, g):
        u, v, colcorr, ids_q, ids_k, pos, lse = ctx.saved_tensors
        g = g.float().contiguous()
        du, dv, dcol = flash_ce_bwd(u, v, colcorr, ids_q, ids_k, pos, lse, g)
        # positive-column (label) terms, as _flash_ce_bwd adds them
        # outside the kernels: d(-s_{i,pos_i}); pos columns are distinct
        idx = pos.long()
        du = du - g[:, None] * v.float()[idx]
        dv = dv.index_add(0, idx, -g[:, None] * u.float())
        dcol = dcol.index_add(0, idx, -g)
        return du.to(u.dtype), dv.to(v.dtype), dcol, None, None, None


def flash_softmax_ce(u, v, colcorr, ids_q, ids_k, pos) -> torch.Tensor:
    return FlashSoftmaxCE.apply(u, v, colcorr, ids_q, ids_k, pos)


def in_batch_softmax_flash(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    log_q: Optional[torch.Tensor] = None,
    item_bias: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    bf16="auto",
    extra_candidates=None,
) -> torch.Tensor:
    """Drop-in equivalent of ``losses.in_batch_softmax`` backed by the
    flash kernels. ``bf16="auto"`` casts u and v to bfloat16 from 8,192
    candidates (the JAX package's threshold, kept for parity: it changes
    the numerics); every reduction stays fp32 inside the kernels.
    ``extra_candidates`` ``(emb [N, D], ids [N], corr [N])`` appends
    negative columns after the in-batch block (the rectangular case);
    positives stay in the first segment."""
    if axis_name is not None:
        raise NotImplementedError(
            "global negatives over a data axis are not ported to "
            "recsys_tpu_torch yet (ROADMAP Queue 1: item 11, multi-GPU)")
    b = user_emb.shape[0]
    n_cand = b + (extra_candidates[0].shape[0] if extra_candidates is not None else 0)
    if bf16 is True or (bf16 == "auto" and n_cand >= 8192):
        user_emb = user_emb.to(torch.bfloat16)
        item_emb = item_emb.to(torch.bfloat16)
    dev = user_emb.device
    colcorr = torch.zeros((b,), dtype=torch.float32, device=dev)
    if item_bias is not None:
        colcorr = colcorr + item_bias
    if log_q is not None:
        colcorr = colcorr - log_q
    ids = item_ids.to(device=dev, dtype=torch.int32)
    cand, cand_ids, cand_corr = item_emb, ids, colcorr
    if extra_candidates is not None:
        x_emb, x_ids, x_corr = extra_candidates
        cand = torch.cat([cand, x_emb.detach().to(cand.dtype)])
        cand_ids = torch.cat([cand_ids, x_ids.to(dtype=torch.int32)])
        cand_corr = torch.cat([cand_corr, x_corr.float()])
    pos = torch.arange(b, dtype=torch.int32, device=dev)
    ce = flash_softmax_ce(user_emb, cand, cand_corr, ids, cand_ids, pos)
    if mask is not None:
        return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)
