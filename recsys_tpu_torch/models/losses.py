"""Loss library: in-batch sampled softmax (dense, chunked, and the flash
kernels' path), explicit sampled softmax, weighted BCE, MSE, balanced
class weights, AUC (the counterpart of ``recsys_tpu/models/losses.py``).

total = retrieval_weight * in_batch_softmax + rating_weight * MSE
      + ctr_weight * class-weighted BCE (+ L2, in ``MultiTaskModel.loss``).

Inputs follow the JAX package's dtypes: under mixed precision the
retrieval embeddings arrive as bf16 tensors, and every product of them is
taken in fp32 on the bf16 values (``preferred_element_type=f32``), so
their gradients round to bf16 at the same points as in JAX.

Data-parallel scopes (``axis_name`` with the :class:`MeshContext`
``mesh_ctx`` that resolves it, inside the trainer's data-parallel step):
the in-batch softmax takes its candidates from the global batch (the
item rows, ids, logQ and bias of every rank, all-gathered in rank order,
the rows differentiably), with local row i's positive in column
``axis_index * B_local + i``; the weighted BCE divides by the mean over
ranks of the weight sum, so the mean over ranks of the loss is the
global weighted mean.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from recsys_tpu_torch.ops import sampled_softmax as ss
from recsys_tpu_torch.utils.trace import span

NEG_BIG = -1e9

# warn once per (setting, regime) pair
_REGIME_WARNED: set = set()

# Candidates from which the "auto" policy takes the flash kernels on the
# card. The value is the JAX package's TPU v5e crossover, unmeasured on
# H100; chip_smoke.py records the card's train-step times on both paths
# (PERF.md) for a later PR to set it.
_FLASH_MIN_CANDIDATES = 8192
# candidates from which the dense path keeps its logits in bf16 (the JAX
# package's threshold, multitask.py; kept for parity: it changes numerics)
BF16_LOGITS_MIN_CANDIDATES = 8192


def _axis(mesh_ctx, axis_name, what: str):
    """The mesh context that resolves ``axis_name`` (None without one)."""
    if axis_name is not None and mesh_ctx is None:
        raise ValueError(f"{what} over axis {axis_name!r} needs the mesh_ctx that "
                         "resolves it")
    return mesh_ctx if axis_name is not None else None


def _gather(ctx, axis_name, x, grad: bool = False):
    """``x`` of every rank on ``axis_name``, concatenated on dim 0 in rank
    order; ``grad=True`` takes the differentiable gather."""
    from recsys_tpu_torch.parallel import collectives

    if x is None:
        return None
    if grad:
        return collectives.all_gather_rows(ctx, x, axis_name)
    return collectives.gather_rows(ctx, x, axis_name)


def resolve_retrieval_loss(setting, b_local: int, n_candidates: int, platform: str,
                           cap_gb: float = 8.0) -> str:
    """Pick ``"xla"`` (dense [B, n_cand] logits, :func:`in_batch_softmax`),
    ``"flash"`` (the CUDA kernels) or ``"chunked"`` (online softmax over
    candidate chunks). ``platform`` is the device type of the batch
    (``"cuda"`` or ``"cpu"``); ``setting`` is ``ModelConfig.use_flash_ce``.

    ``"auto"``: on the card, flash from ``_FLASH_MIN_CANDIDATES`` up, dense
    below; elsewhere dense while the bf16 logits fit ``cap_gb``, chunked
    above. True / False / "chunked" force a path, with a warning in the
    regime the JAX package measured as losing (TPU measurements)."""
    logits_gb = b_local * n_candidates * 2 / 2**30  # bf16 footprint
    fits = logits_gb <= cap_gb
    flash_wins = platform == "cuda" and n_candidates >= _FLASH_MIN_CANDIDATES

    def _warn(msg):
        key = (repr(setting), fits, flash_wins, platform)
        if key not in _REGIME_WARNED:
            _REGIME_WARNED.add(key)
            warnings.warn(msg, stacklevel=3)

    if setting is True:
        if fits and not flash_wins:
            _warn(f"use_flash_ce=True at [{b_local}, {n_candidates}] logits on "
                  f"{platform}: the 'auto' policy takes the dense path here (on the "
                  f"card it takes flash from {_FLASH_MIN_CANDIDATES} candidates, a TPU "
                  "crossover unmeasured on H100)")
        return "flash"
    if setting == "chunked":
        return "chunked"
    if setting is False:
        if not fits:
            _warn(f"use_flash_ce=False with a [{b_local}, {n_candidates}] logits "
                  f"matrix ({logits_gb:.1f} GB bf16 > cap {cap_gb} GB): the dense "
                  "path materializes it and may run out of memory")
        elif flash_wins:
            _warn(f"use_flash_ce=False at [{b_local}, {n_candidates}] logits on the "
                  "card: the 'auto' policy would take the flash kernels here")
        return "xla"
    if flash_wins:
        return "flash"
    if fits:
        return "xla"
    return "flash" if platform == "cuda" else "chunked"


def _column_corr(b: int, item_bias, log_q, device) -> torch.Tensor:
    corr = torch.zeros((b,), dtype=torch.float32, device=device)
    if item_bias is not None:
        corr = corr + item_bias
    if log_q is not None:
        corr = corr - log_q
    return corr


def _masked_mean(ce: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)


def in_batch_softmax(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_ids: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    mask: Optional[torch.Tensor] = None,
    log_q: Optional[torch.Tensor] = None,
    item_bias: Optional[torch.Tensor] = None,
    logits_dtype=None,
    extra_candidates=None,
    mesh_ctx=None,
) -> torch.Tensor:
    """In-batch sampled-softmax retrieval loss over the dense [B, n_cand]
    logits: label = the diagonal, logQ correction ``- log_q``, ``+ item_bias``
    per candidate column, accidental hits (``item_ids`` equal, off the
    diagonal) set to -1e9. ``extra_candidates`` ``(emb [N, D], ids [N],
    corr [N])`` appends negative columns (no gradient into them).
    ``logits_dtype=torch.bfloat16`` rounds the logits to bf16 and takes a
    hand-rolled logsumexp with fp32 accumulation, as the JAX bf16 branch.
    With ``axis_name`` (and ``mesh_ctx``) the candidates are the global
    batch's (see the module docstring)."""
    ctx = _axis(mesh_ctx, axis_name, "in_batch_softmax")
    b = user_emb.shape[0]
    candidates, cand_ids, cand_logq, cand_bias = item_emb, item_ids, log_q, item_bias
    first = 0  # the column of row 0's positive
    if ctx is not None:
        candidates = _gather(ctx, axis_name, item_emb, grad=True)
        cand_ids = _gather(ctx, axis_name, item_ids)
        cand_logq = _gather(ctx, axis_name, log_q)
        cand_bias = _gather(ctx, axis_name, item_bias, grad=True)
        first = ctx.axis_index(axis_name) * b
    if extra_candidates is not None:
        x_emb, x_ids, x_corr = extra_candidates
        corr_full = torch.cat([_column_corr(candidates.shape[0], cand_bias, cand_logq,
                                            user_emb.device), x_corr.float()])
        candidates = torch.cat([candidates, x_emb.detach().to(candidates.dtype)])
        if cand_ids is not None:
            cand_ids = torch.cat([cand_ids, x_ids.to(cand_ids.dtype)])
        cand_bias, cand_logq = corr_full, None  # one fused column add
    logits = torch.matmul(user_emb.float(), candidates.float().T)
    bf16_logits = logits_dtype == torch.bfloat16
    if bf16_logits:
        logits = logits.to(torch.bfloat16)
    if cand_bias is not None:
        logits = logits + cand_bias.to(logits.dtype)[None, :]
    if cand_logq is not None:
        logits = logits - cand_logq.to(logits.dtype)[None, :]
    if cand_ids is not None and item_ids is not None:
        col = torch.arange(logits.shape[1], device=logits.device)
        diag = torch.arange(first, first + b, device=logits.device)
        accidental = (item_ids[:, None] == cand_ids[None, :]) & (col[None, :] != diag[:, None])
        logits = torch.where(accidental, torch.full_like(logits, NEG_BIG), logits)
    # the positive logit as a row-wise dot (the same value as the diagonal)
    pos = torch.sum(user_emb.float() * item_emb.float(), dim=-1)
    if item_bias is not None:
        pos = pos + item_bias
    if log_q is not None:
        pos = pos - log_q
    if bf16_logits:
        m = torch.max(logits, dim=-1).values
        s = torch.sum(torch.exp((logits - m[:, None]).float()), dim=-1)
        lse = torch.log(s) + m.float()
    else:
        lse = torch.logsumexp(logits, dim=-1)
    return _masked_mean(lse - pos, mask)


def in_batch_softmax_chunked(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_ids: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    mask: Optional[torch.Tensor] = None,
    log_q: Optional[torch.Tensor] = None,
    item_bias: Optional[torch.Tensor] = None,
    chunk_size: int = 4096,
    extra_candidates=None,
    mesh_ctx=None,
) -> torch.Tensor:
    """The same loss with candidates swept in chunks of ``chunk_size`` and
    an online logsumexp; each chunk is checkpointed, so the backward
    recomputes its logits and the [B, n_cand] matrix never exists whole.
    ``extra_candidates`` are padded to a chunk multiple with -1e9 columns.
    With ``axis_name`` (and ``mesh_ctx``) the candidates and their folded
    column corrections are the global batch's."""
    ctx = _axis(mesh_ctx, axis_name, "in_batch_softmax_chunked")
    b, d = user_emb.shape
    dev = user_emb.device
    col_corr = _column_corr(b, item_bias, log_q, dev)
    candidates, cand_ids, cand_corr = item_emb, item_ids, col_corr
    first = 0  # the column of row 0's positive
    if ctx is not None:
        candidates = _gather(ctx, axis_name, item_emb, grad=True)
        cand_ids = _gather(ctx, axis_name, item_ids)
        cand_corr = _gather(ctx, axis_name, col_corr, grad=True)
        first = ctx.axis_index(axis_name) * b
    if extra_candidates is not None:
        x_emb, x_ids, x_corr = extra_candidates
        total = candidates.shape[0] + x_emb.shape[0]
        pad = (-total) % min(chunk_size, total)
        candidates = torch.cat([candidates, x_emb.detach().to(candidates.dtype),
                                candidates.new_zeros((pad, d))])
        cand_corr = torch.cat([cand_corr, x_corr.float(),
                               torch.full((pad,), NEG_BIG, device=dev)])
        if cand_ids is not None:
            cand_ids = torch.cat([cand_ids, x_ids.to(cand_ids.dtype),
                                  torch.full((pad,), -1, dtype=cand_ids.dtype, device=dev)])
    n_cand = candidates.shape[0]
    chunk_size = min(chunk_size, n_cand)
    if n_cand % chunk_size:
        raise ValueError(f"in_batch_softmax_chunked: {n_cand} candidates are not a "
                         f"multiple of chunk_size {chunk_size}")
    diag = torch.arange(first, first + b, device=dev)

    def chunk_lse(u, v_c, corr_c, ids_c, c0):
        s = torch.matmul(u.float(), v_c.float().T) + corr_c[None, :]
        if item_ids is not None:
            col = c0 + torch.arange(v_c.shape[0], device=dev)
            accidental = (item_ids[:, None] == ids_c[None, :]) & (col[None, :] != diag[:, None])
            s = torch.where(accidental, torch.full_like(s, NEG_BIG), s)
        return torch.logsumexp(s, dim=-1)

    lse = torch.full((b,), -float("inf"), device=dev)
    for c0 in range(0, n_cand, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        ids_c = cand_ids[sl] if cand_ids is not None else None
        lse = torch.logaddexp(lse, checkpoint(chunk_lse, user_emb, candidates[sl],
                                              cand_corr[sl], ids_c, c0,
                                              use_reentrant=False))
    pos = torch.sum(user_emb.float() * item_emb.float(), dim=-1) + col_corr
    return _masked_mean(lse - pos, mask)


def sampled_softmax_explicit(user_emb: torch.Tensor, pos_item_emb: torch.Tensor,
                             neg_item_embs: torch.Tensor) -> torch.Tensor:
    """Explicit-negatives retrieval loss: softmax over [pos | K negs] per
    row, the positive in column 0."""
    pos = torch.sum(user_emb * pos_item_emb, dim=-1, keepdim=True)
    neg = torch.einsum("bd,bkd->bk", user_emb, neg_item_embs)
    logits = torch.cat([pos, neg], dim=-1)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[:, 0])


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    sq = torch.square(pred - target)
    return _masked_mean(sq, mask)


def weighted_bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                        pos_weight: float = 1.0, neg_weight: float = 1.0,
                        mask: Optional[torch.Tensor] = None,
                        axis_name: Optional[str] = None,
                        mesh_ctx=None) -> torch.Tensor:
    """Per-sample class-weighted sigmoid cross-entropy on logits,
    normalized by the weight sum (a weighted mean). With ``axis_name`` the
    denominator is the mean over ranks of the weight sum (detached: the
    weights depend on the labels only), so the mean over ranks of this
    value is the global batch's weighted mean."""
    ctx = _axis(mesh_ctx, axis_name, "the global BCE denominator")
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    w = torch.where(labels >= 0.5, torch.full_like(per, pos_weight),
                    torch.full_like(per, neg_weight))
    if mask is not None:
        w = w * mask
    w_sum = torch.sum(w)
    if ctx is not None:
        from recsys_tpu_torch.parallel import collectives

        w_sum = collectives.allreduce_mean(ctx, w_sum.detach(), axis_name)
    return torch.sum(per * w) / torch.clamp(w_sum, min=1e-6)


def balanced_class_weights(y) -> Tuple[float, float]:
    """sklearn ``compute_class_weight('balanced')``: w_c = n / (2 * n_c),
    on the host (once per training job) -> (w_pos, w_neg)."""
    y = np.asarray(y)
    n = len(y)
    n_pos = max(float((y >= 0.5).sum()), 1.0)
    n_neg = max(float(n - n_pos), 1.0)
    return n / (2.0 * n_pos), n / (2.0 * n_neg)


def auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ROC-AUC via the rank-sum statistic (ties ranked in input order by
    a stable sort, as ``jnp.argsort`` does), in the scores' dtype."""
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores)
    ranks[order] = torch.arange(1, scores.shape[0] + 1, dtype=scores.dtype,
                                device=scores.device)
    pos = labels >= 0.5
    n_pos = torch.sum(pos).to(scores.dtype)
    n_neg = scores.shape[0] - n_pos
    rank_sum = torch.sum(torch.where(pos, ranks, torch.zeros_like(ranks)))
    a = (rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos == 0) | (n_neg == 0), torch.full_like(a, 0.5), a)


def sampled_softmax(q: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                    neg: torch.Tensor, temperature: float) -> torch.Tensor:
    """The sampled softmax of HSTU's loss (``models/hstu.py``): rows q [M,
    D] against their positive ``table[pos]`` [M] and negatives
    ``table[neg]`` [M, K], logits ``q . e / temperature`` (the caller
    L2-normalises q and the table: cosines), a negative equal to its
    positive masked out; -> the mean over rows of ``logsumexp(logits) -
    positive logit``, fp32, differentiable in q and ``table``
    (``ops/sampled_softmax.py``: kernel row 13 on the card, no [M, K, D]
    tensor on either device). Its forward runs under the span
    ``loss.sampled``."""
    with span("loss.sampled"):
        return ss.sampled_softmax(q.float(), table.float(), pos, neg, float(temperature))
