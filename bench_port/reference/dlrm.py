"""DLRM-DCNv2 and its training step in plain PyTorch, fp32 (TF32 off), with
no kernel, cache or batching of the program's: the plain reference of the
``mlperf-dlrm-dcnv2-1of8`` configuration, and of the port's tests.

Written from the equations of the source (MLPerf Training's
``recommendation_v2/torchrec_dlrm``, DLRM arXiv:1906.00091, DCN V2
arXiv:2008.13535):

* bag ``e_t = sum_{j in bag_t} E_t[id_j]`` (sum pooling);
* bottom MLP with ReLU after every layer; x0 = concat(bottom, e_1 .. e_T);
* low-rank cross ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``;
* over arch with ReLU after every layer, then a linear layer to a logit;
* the mean binary cross-entropy ``max(z, 0) - z y + log(1 + exp(-|z|))``;
* the tables' row-wise Adagrad ``G_r += mean_d(g_r^2); w_r -= lr g_r /
  (sqrt(G_r) + eps)`` over the dense [rows, D] table gradient (a row the
  batch missed has g = 0 and stays); the dense leaves' Adagrad
  ``a += g^2; p -= lr g / (sqrt(a) + 1e-7)``, ``a`` from 0.1.

Departures from the source, each the configuration's (its ``assumed``):
``fmt`` rounds the operands of every matrix product, forward and backward
(the incoming gradient too), to bf16 with fp32 products and sums, where
the source computes in fp32; the dense leaves' Adagrad starts its
accumulators at 0.1 with eps 1e-7 (the port's; torch.optim.Adagrad starts
at 0 with eps 1e-10); the learning rate is the fp32 value of the
configured one, constant. ``fmt="fp8"`` is the control (e4m3, one scale a
tensor); ``fault`` plants a fault in the reference itself: "mean_bags"
pools each bag by its mean, "drop_table:<t>" leaves table t unchanged by
its update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_port.reference.model import _quantize

DENSE_ACCUM0 = 0.1
DENSE_EPS = 1e-7
ROWWISE_EPS = 1e-8


class _Mm(torch.autograd.Function):
    """``x @ w`` with the operands rounded to ``fmt`` in the forward and in
    both products of the backward (the incoming gradient too)."""

    @staticmethod
    def forward(ctx, x, w, fmt):
        xq, wq = _quantize(x, fmt), _quantize(w, fmt)
        ctx.save_for_backward(xq, wq)
        ctx.fmt = fmt
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _quantize(g, ctx.fmt)
        return gq @ wq.T, xq.T @ gq, None


def mm(x: torch.Tensor, w: torch.Tensor, fmt: str) -> torch.Tensor:
    return _Mm.apply(x, w, fmt)


def _mlp(p: Dict, x: torch.Tensor, fmt: str, final_relu: bool) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = mm(x, p[f"layer_{i}"]["w"], fmt) + p[f"layer_{i}"]["b"]
        if i < n - 1 or final_relu:
            x = torch.relu(x)
    return x


def cross(p: Dict, x0: torch.Tensor, fmt: str) -> torch.Tensor:
    """The low-rank cross layers."""
    xl = x0
    for i in range(len(p)):
        q = p[f"layer_{i}"]
        xl = x0 * (mm(mm(xl, q["v"], fmt), q["w"], fmt) + q["b"]) + xl
    return xl


def bags(table: torch.Tensor, sparse: torch.Tensor, table_rows: Sequence[int],
         bag_sizes: Sequence[int], mean: bool = False) -> torch.Tensor:
    """[n, S] ids -> [n, T, D]: each bag's rows summed (or averaged)."""
    out, c, off = [], 0, 0
    for rows, h in zip(table_rows, bag_sizes):
        e = table[off + sparse[:, c].long()]
        for j in range(1, h):
            e = e + table[off + sparse[:, c + j].long()]
        out.append(e / h if mean else e)
        c += h
        off += rows
    return torch.stack(out, dim=1)


def logits(params: Dict, dense: torch.Tensor, bag: torch.Tensor, fmt: str) -> torch.Tensor:
    bottom = _mlp(params["bottom_mlp"], dense, fmt, final_relu=True)
    x0 = torch.cat([bottom, bag.reshape(bag.shape[0], -1)], dim=1)
    return _mlp(params["over_arch"], cross(params["cross"], x0, fmt), fmt,
                final_relu=False)[:, 0]


def bce_sum(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def dense_leaves(params: Dict, prefix=()):
    out = []
    for k in sorted(params):
        if k == "embedding" and not prefix:
            continue
        v = params[k]
        out += dense_leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def loss_and_grads(params: Dict, batch: Dict[str, torch.Tensor], model: Dict, fmt: str,
                   rows: int, mean_bags: bool = False):
    """The mean BCE of one batch, computed ``rows`` examples at a time ->
    (loss, {dense path: grad}, the table's dense gradient [n_rows, D])."""
    table = params["embedding"]["table"]
    leaves = dense_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
        p.grad = None
    g_table = torch.zeros_like(table)
    n = batch["label"].shape[0]
    total = 0.0
    tr, bs = model["table_rows"], model["bag_sizes"]
    for r0 in range(0, n, rows):
        sl = slice(r0, min(r0 + rows, n))
        sparse = batch["sparse"][sl]
        bag = bags(table, sparse, tr, bs, mean_bags).requires_grad_(True)
        z = logits(params, batch["dense"][sl], bag, fmt)
        loss = bce_sum(z, batch["label"][sl]) / n
        loss.backward()
        total += float(loss.detach())
        c, off = 0, 0
        for t, (rows_t, h) in enumerate(zip(tr, bs)):
            g = bag.grad[:, t] / h if mean_bags else bag.grad[:, t]
            for j in range(h):
                g_table.index_add_(0, off + sparse[:, c + j].long(), g)
            c += h
            off += rows_t
        del bag, z, loss
    grads = {p: leaf.grad.detach().clone() for p, leaf in leaves}
    for _, p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return total, grads, g_table


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def adagrad_steps(params: Dict, accum: Dict, row_accum: torch.Tensor, grads: Dict,
                  g_table: torch.Tensor, lr: float, skip_table: Optional[range] = None,
                  row_chunk: int = 1 << 20) -> None:
    """The dense leaves' Adagrad and the table's row-wise Adagrad, in place
    (the table a ``row_chunk`` of rows at a time; rows in ``skip_table``,
    and their slots, left alone)."""
    for path, g in grads.items():
        a = _get(accum, path)
        a.add_(torch.square(g))
        _get(params, path).sub_(lr * g / (torch.sqrt(a) + DENSE_EPS))
    table = params["embedding"]["table"]
    for r0 in range(0, table.shape[0], row_chunk):
        sl = slice(r0, min(r0 + row_chunk, table.shape[0]))
        g = g_table[sl]
        if skip_table is not None:
            r = torch.arange(sl.start, sl.stop, device=g.device)
            g = torch.where(((r >= skip_table.start) & (r < skip_table.stop))[:, None],
                            torch.zeros_like(g), g)
        row_accum[sl] += torch.mean(torch.square(g), dim=1)
        table[sl] -= lr * g / (torch.sqrt(row_accum[sl])[:, None] + ROWWISE_EPS)


def table_leaf_names(model: Dict) -> List[str]:
    return [f"table/t{t:02d}" for t in range(len(model["table_rows"]))]


def slot_norms(accum: Dict, row_accum: torch.Tensor, model: Dict) -> Dict[str, float]:
    """Each leaf's first-gradient norm as the slots hold it after one
    step: a dense leaf's sqrt(sum(a - 0.1)), a table's sqrt(D * sum(G))."""
    a0 = float(torch.tensor(DENSE_ACCUM0, dtype=torch.float32))
    out = {"/".join(p): math.sqrt(max(float(torch.sum(a.double() - a0)), 0.0))
           for p, a in dense_leaves(accum)}
    d, off = model["embedding_dim"], 0
    for name, rows in zip(table_leaf_names(model), model["table_rows"]):
        out[name] = math.sqrt(d * float(torch.sum(row_accum[off:off + rows].double())))
        off += rows
    return out


@torch.no_grad()
def change_norms(params: Dict, dense0: Dict, table0: Callable[[int], torch.Tensor],
                 model: Dict) -> Dict[str, float]:
    """Each leaf's change from the first weights (``dense0``: the dense
    leaves by path; ``table0(t)``: table t's first rows)."""
    out = {"/".join(p): float(torch.linalg.vector_norm((v - dense0[p]).double()))
           for p, v in dense_leaves(params)}
    table, off = params["embedding"]["table"], 0
    for t, (name, rows) in enumerate(zip(table_leaf_names(model), model["table_rows"])):
        out[name] = float(torch.linalg.vector_norm((table[off:off + rows] - table0(t)).double()))
        off += rows
    return out


def follow_steps(params: Dict, batches: List[Dict[str, torch.Tensor]], model: Dict,
                 train: Dict, table0: Callable[[int], torch.Tensor], fmt: str = "bf16",
                 rows: int = 16384, fault: str = "") -> Dict:
    """len(batches) training steps from ``params`` (changed in place) -> the
    readings the check compares: each step's loss, each leaf's first
    gradient norm as the slots hold it after step 1, each leaf's change
    after the last step, and each leaf's exact first gradient norm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dense0 = {p: v.clone() for p, v in dense_leaves(params)}
    accum: Dict = {}
    for p, v in dense_leaves(params):
        node = accum
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = torch.full_like(v, DENSE_ACCUM0)
    table = params["embedding"]["table"]
    row_accum = torch.zeros((table.shape[0],), device=table.device)
    lr = float(np.float32(train["learning_rate"]))
    skip = None
    if fault.startswith("drop_table:"):
        t = int(fault.split(":")[1])
        lo = sum(model["table_rows"][:t])
        skip = range(lo, lo + model["table_rows"][t])
    out: Dict = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for step, batch in enumerate(batches):
        loss, grads, g_table = loss_and_grads(params, batch, model, fmt, rows,
                                              mean_bags=fault == "mean_bags")
        out["loss"].append(loss)
        if step == 0:
            exact = {"/".join(p): float(torch.linalg.vector_norm(g.double()))
                     for p, g in grads.items()}
            off = 0
            for name, r in zip(table_leaf_names(model), model["table_rows"]):
                exact[name] = float(torch.linalg.vector_norm(g_table[off:off + r].double()))
                off += r
            out["exact_grad_norm"] = exact
        adagrad_steps(params, accum, row_accum, grads, g_table, lr, skip)
        del grads, g_table
        if step == 0:
            out["grad_norm"] = slot_norms(accum, row_accum, model)
    out["change_norm"] = change_norms(params, dense0, table0, model)
    return out
