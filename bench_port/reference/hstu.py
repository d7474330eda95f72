"""HSTU and its training step in plain PyTorch, fp32 (TF32 off), with no
kernel, layout or batching of the program's: the plain reference of the
``hstu-ml20m-large-l4096`` configuration, and of the port's tests.

Written from the equations of the source (Zhai et al., *Actions Speak
Louder than Words*, ICML 2024, arXiv:2402.17152, section 3; the public
code's HSTU encoder and the ``ml-20m`` gin configuration): with d the
embedding width, H heads of 64, N = max_sequence_length and one user's
sequence of n <= N events (item ids, int64 timestamps t),

* input ``X = item_table[ids] * sqrt(d) + pos_emb[0..n)``, dropout;
* each block: ``X^ = LayerNorm(X)`` (no affine, eps 1e-6);
  ``U, V, Q, K = split(SiLU(X^ W_uvqk))``;
  ``A_h = SiLU(Q_h K_h^T + B) / N``, masked to j <= i, with
  ``B[i, j] = p[(j - i) + N - 1] + w[bucket(t'_i - t_j)]``,
  ``bucket(x) = min(128, (int)(log(max(|x|, 1)) / 0.301))`` (in fp32, the
  division as the product by fp32(1 / 0.301), as PyTorch divides a tensor
  by a scalar on the card, so it reads the same on either device), t'_i the
  timestamp of event i + 1 (the last event's own), one B for every head;
  ``Y = X + dropout(U * LayerNorm(concat_h A_h V_h)) W_o + b_o``;
* output: the last block's rows, L2-normalised (eps 1e-6);
* loss: at every event i with a next event, ``cos(output_i, item_{i+1}) /
  temperature`` against the K given negatives' cosines (a negative equal
  to the positive left out), ``logsumexp - positive``, the mean over
  those events of the batch;
* Adam ``m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p -= lr (m /
  (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)`` on every leaf (the
  source's AdamW with weight decay 0).

Each sequence is padded to its group's longest and its scores [H, L, L]
materialised, a group of sequences at a time (at most ``PAIRS_BUDGET``
padded pairs and ``EVENTS_BUDGET`` events a group), each group's loss
taken back through autograd on its own (the loss is a sum over events,
the attention stays inside a sequence).

Departures from the source, each the configuration's: the history length
(max_sequence_length 4,096 where the gin file has 200); ``fmt`` rounds the
operands of every matrix product, forward and backward (the incoming
gradient too), to bf16 with fp32 sums, as the program does (the source
computes in fp32 with TF32); the batch is given jagged (the program's
layout) and padded here a group at a time (the source pads every
sequence to N); dropout masks and negatives are given, drawn by the
program. ``fmt="fp8"`` is the control (e4m3, one scale a tensor);
``fault`` plants a fault in the reference itself: "no_time_bias" leaves
w's term out, "own_n" divides the scores by each sequence's own n instead
of N, "no_diagonal" masks the diagonal out (j < i).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.dlrm import mm
from bench_port.reference.model import _quantize

HEAD = 64
NUM_BUCKETS = 128
LN_EPS = 1e-6
NORM_EPS = 1e-6
ADAM = (0.9, 0.999, 1e-8)
PAIRS_BUDGET = 1 << 25   # padded pairs of a group: its [H, L, L] fp32 scores 512 MiB at H = 4
EVENTS_BUDGET = 8192     # events of a group: its negatives' rows [., K, d] fp32 1 GiB


class _Bmm(torch.autograd.Function):
    """``a @ b`` (batched) with the operands rounded to ``fmt`` in the
    forward and in both products of the backward (the incoming gradient
    too)."""

    @staticmethod
    def forward(ctx, a, b, fmt):
        aq, bq = _quantize(a, fmt), _quantize(b, fmt)
        ctx.save_for_backward(aq, bq)
        ctx.fmt = fmt
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _quantize(g, ctx.fmt)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq, None


INV_BASE = float(np.float32(1.0) / np.float32(0.301))


class _Lookup(torch.autograd.Function):
    """``w[idx]`` of a 1-D ``w``, its gradient summed into ``w``'s entries
    by ``index_add_`` (autograd's own gather backward runs each entry's
    duplicates one after another: minutes at the cell's ~10^8 pairs)."""

    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.n = w.shape[0]
        return w[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gw = torch.zeros(ctx.n, dtype=g.dtype, device=g.device)
        return gw.index_add_(0, idx.reshape(-1), g.reshape(-1)), None


def bucket(dt: torch.Tensor) -> torch.Tensor:
    x = torch.log(torch.abs(dt).clamp(min=1).to(torch.float32)) * INV_BASE
    return x.to(torch.int64).clamp(0, NUM_BUCKETS)


def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """{"a/b/c": leaf} of a nested dict."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = v

    walk(params, ())
    return out


def _groups(lengths: List[int]) -> List[range]:
    """Consecutive sequences within the budgets (one at least)."""
    out, first = [], 0
    for s in range(1, len(lengths) + 1):
        if s < len(lengths):
            grp = lengths[first:s + 1]
            if len(grp) * max(grp) ** 2 <= PAIRS_BUDGET and sum(grp) <= EVENTS_BUDGET:
                continue
        out.append(range(first, s))
        first = s
    return out


def attention_padded(pos_w, ts_w, v, q, k, ts_next, ts, valid, n_seq, n_max: int,
                     fmt: str = "fp32", fault: str = "") -> torch.Tensor:
    """v, q, k [S, L, H 64] of S padded sequences (``valid`` [S, L], their
    lengths ``n_seq`` [S], timestamps ``ts`` and next timestamps
    ``ts_next`` [S, L]) -> concat_h A_h V_h [S, L, H 64]."""
    s_, l_, w = q.shape
    h = w // HEAD

    def heads(x):
        return x.reshape(s_, l_, h, HEAD).transpose(1, 2).reshape(s_ * h, l_, HEAD)

    i = torch.arange(l_, device=q.device)
    bias = _Lookup.apply(pos_w, i[None, :] - i[:, None] + n_max - 1)[None]  # [1, L, L]
    if fault != "no_time_bias":
        bias = bias + _Lookup.apply(ts_w, bucket(ts_next[:, :, None] - ts[:, None, :]))
    causal = (i[None, :] < i[:, None]) if fault == "no_diagonal" else (i[None, :] <= i[:, None])
    mask = causal[None] & valid[:, :, None]                             # [S, L, L]
    scores = _Bmm.apply(heads(q), heads(k).transpose(1, 2), fmt).reshape(s_, h, l_, l_)
    x = scores + bias[:, None]
    divisor = n_seq.to(torch.float32)[:, None, None, None] if fault == "own_n" else n_max
    a = torch.where(mask[:, None], F.silu(x) / divisor, torch.zeros_like(x))
    o = _Bmm.apply(a.reshape(s_ * h, l_, l_), heads(v), fmt)
    return o.reshape(s_, h, l_, HEAD).transpose(1, 2).reshape(s_, l_, w)


def attention(v, q, k, pos_w, ts_w, timestamps, lengths, n_max: int,
              fmt: str = "fp32") -> torch.Tensor:
    """The attention of a jagged batch (v, q, k [events, H 64], sequences
    of ``lengths`` end to end), each sequence on its own -> [events, H
    64]."""
    out, start = [], 0
    for n in (int(x) for x in lengths):
        sl = slice(start, start + n)
        ts = timestamps[sl][None]
        nxt = torch.cat([timestamps[sl][1:], timestamps[sl][-1:]])[None]
        valid = torch.ones((1, n), dtype=torch.bool, device=q.device)
        out.append(attention_padded(pos_w, ts_w, v[sl][None], q[sl][None], k[sl][None], nxt, ts,
                                    valid, torch.tensor([n], device=q.device), n_max, fmt)[0])
        start += n
    return torch.cat(out)


def group_loss_sum(params: Dict, model: Dict, batch: Dict, seqs: range, fmt: str = "bf16",
                   fault: str = "") -> torch.Tensor:
    """The sum of the loss over the supervised events of sequences
    ``seqs`` of ``batch`` (their padded group, differentiable in
    ``params``); the batch's tensors on ``params``' device."""
    dev = params["item_table"].device
    d, n_max, rate = model["embedding_dim"], model["hstu_max_len"], model["dropout_rate"]
    lengths = [int(n) for n in batch["lengths"]]
    starts = np.concatenate([[0], np.cumsum(lengths)])
    sup_starts = np.concatenate([[0], np.cumsum([n - 1 for n in lengths])])
    ls = [lengths[s] for s in seqs]
    l_ = max(ls)
    rows = torch.full((len(ls), l_), -1, dtype=torch.int64)
    for r, s in enumerate(seqs):
        rows[r, :lengths[s]] = torch.arange(starts[s], starts[s] + lengths[s])
    rows = rows.to(dev)
    valid = rows >= 0
    idx = rows.clamp(min=0)
    n_seq = torch.tensor(ls, device=dev)
    items = batch["items"].long()[idx]
    ts = batch["timestamps"][idx]
    pos = torch.arange(l_, device=dev)
    last = (n_seq - 1)[:, None]
    ts_next = torch.gather(ts, 1, torch.minimum(pos[None, :] + 1, last).expand(len(ls), l_))
    draws = batch["draws"]

    def dropout(x, key):
        if key not in draws:
            return x
        m = draws[key][idx]
        return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))

    x = params["item_table"][items] * math.sqrt(d) + params["pos_emb"][pos][None]
    x = torch.where(valid[:, :, None], dropout(x, "input"), torch.zeros_like(x))
    w = model["hstu_heads"] * HEAD
    for b in range(model["hstu_blocks"]):
        p = params[f"block_{b}"]
        xn = F.layer_norm(x, (d,), eps=LN_EPS)
        uvqk = F.silu(mm(xn.reshape(-1, d), p["uvqk"]["w"], fmt)).reshape(len(ls), l_, 4 * w)
        u, v, q, k = uvqk.split(w, dim=2)
        o = attention_padded(p["pos_w"], p["ts_w"], v, q, k, ts_next, ts, valid, n_seq, n_max,
                             fmt, fault)
        y = dropout(u * F.layer_norm(o, (w,), eps=LN_EPS), f"block_{b}")
        x = x + (mm(y.reshape(-1, w), p["o"]["w"], fmt) + p["o"]["b"]).reshape(len(ls), l_, d)
    out = x / torch.clamp(torch.linalg.vector_norm(x, dim=2, keepdim=True), min=NORM_EPS)
    table = params["item_table"]
    table_n = table / torch.clamp(torch.linalg.vector_norm(table, dim=1, keepdim=True),
                                  min=NORM_EPS)
    total = torch.zeros((), device=dev)
    t = model["softmax_temperature"]
    for r, s in enumerate(seqs):
        n = lengths[s]
        if n < 2:
            continue
        qv = out[r, :n - 1]
        pos_ids = items[r, 1:n]
        neg = draws["negatives"][sup_starts[s]:sup_starts[s + 1]]
        lp = torch.sum(qv * table_n[pos_ids], dim=1) / t
        ln = torch.einsum("mkd,md->mk", table_n[neg], qv) / t
        ln = torch.where(neg == pos_ids[:, None], -float("inf"), ln)
        lse = torch.logsumexp(torch.cat([lp[:, None], ln], dim=1), dim=1)
        total = total + torch.sum(lse - lp)
    return total


def loss_and_grads(params: Dict, model: Dict, batch: Dict, fmt: str = "bf16",
                   fault: str = "") -> torch.Tensor:
    """The batch's mean loss; each leaf's gradient added to its ``.grad``."""
    dev = params["item_table"].device
    batch = {"items": batch["items"].to(dev), "timestamps": batch["timestamps"].to(dev),
             "lengths": batch["lengths"],
             "draws": {k: v.to(dev) for k, v in batch["draws"].items()}}
    lengths = [int(n) for n in batch["lengths"]]
    m = sum(lengths) - len(lengths)
    total = 0.0
    for seqs in _groups(lengths):
        part = group_loss_sum(params, model, batch, seqs, fmt, fault) / max(m, 1)
        part.backward()
        total += float(part.detach())
    return torch.tensor(total)


def adam_steps(params: Dict, model: Dict, train: Dict, batches: List[Dict], fmt: str = "bf16",
               fault: str = "") -> Dict:
    """Adam over ``batches`` from ``params`` (updated in place) -> {"loss":
    [per step], "grad_norm": {leaf: the first step's gradient norm}}."""
    b1, b2, eps = ADAM
    lr = float(np.float32(train["learning_rate"]))
    flat = leaves(params)
    slots = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in flat.items()}
    out = {"loss": [], "grad_norm": {}}
    for step, batch in enumerate(batches):
        for v in flat.values():
            v.grad = None
        out["loss"].append(float(loss_and_grads(params, model, batch, fmt, fault)))
        t = np.float32(step) + np.float32(1.0)
        mhat = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
        vhat = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
        with torch.no_grad():
            for k, p in flat.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if step == 0:
                    out["grad_norm"][k] = float(torch.linalg.vector_norm(g.double()))
                m, v = slots[k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * (m * mhat) / (torch.sqrt(v * vhat) + eps))
    return out


def change_norms(params: Dict, params0: Dict) -> Dict[str, float]:
    """Each leaf's change from ``params0``, as a norm."""
    p0 = leaves(params0)
    return {k: float(torch.linalg.vector_norm((v.detach() - p0[k]).double()))
            for k, v in leaves(params).items()}


def follow_steps(params0: Dict, batches: List[Dict], model: Dict, train: Dict,
                 fmt: str = "bf16", fault: str = "") -> Dict:
    """The reference's readings of the checked steps: each step's loss, the
    first gradient's norm and the change after the last step, a leaf at a
    time (``compare.train_numbers``'s input)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = clone_params(params0)
        out = adam_steps(params, model, train, batches, fmt, fault)
        out["change_norm"] = change_norms(params, params0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out


def clone_params(tree):
    if isinstance(tree, dict):
        return {k: clone_params(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def program_readings(losses: List[float], mu_after_first: Dict, params: Dict,
                     params0: Dict) -> Dict:
    """The program's readings in the same form: the first gradient's norm
    from Adam's first moment after the first step (``(1 - b1) g``)."""
    b1 = ADAM[0]
    return {"loss": list(losses),
            "grad_norm": {k: float(torch.linalg.vector_norm(v.double())) / (1 - b1)
                          for k, v in leaves(mu_after_first).items()},
            "change_norm": change_norms(params, params0)}
