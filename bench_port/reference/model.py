"""The model and its training step in plain PyTorch.

``fmt`` is the precision of the operands the configuration rounds
(mixed precision: bf16, products and sums in fp32). Rounding is an
autograd op that also rounds the gradient flowing back through it, as a
cast to a narrower type does. ``fmt="fp8"`` is the control: the same
model with those operands in fp8 (e4m3, one scale a tensor).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NEG_BIG = -1e9
FP8_MAX = 448.0  # largest finite e4m3 value


def _quantize(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "fp32":
        return x
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        amax = x.detach().abs().max()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown precision {fmt!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _quantize(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, ctx.fmt), None


def rnd(x: torch.Tensor, fmt: str) -> torch.Tensor:
    return x if fmt == "fp32" else _Round.apply(x, fmt)


def dense(p: Dict, x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """``x @ w + b`` in fp32; operands rounded to ``fmt`` (None: fp32)."""
    w = p["w"]
    if fmt is not None:
        x, w = rnd(x, fmt), rnd(w, fmt)
    return torch.matmul(x, w) + p["b"]


def mlp(p: Dict, x: torch.Tensor, fmt: str, final_relu: bool) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"layer_{i}"], x, fmt)
        if i < n - 1 or final_relu:
            x = torch.relu(x)
    return x


def tower(table: torch.Tensor, p: Dict, ids: torch.Tensor, fmt: str,
          residual: bool) -> torch.Tensor:
    rows = table[ids.long().clamp(0, table.shape[0] - 1)]
    out = mlp(p, rows, fmt, final_relu=False)
    return out + rows if residual else out


def user_tower(params, ids, model, fmt):
    tw = params["towers"]
    return tower(tw["user_table"], tw["user_tower"], ids, fmt, model["tower_residual"])


def item_tower(params, ids, model, fmt):
    tw = params["towers"]
    return tower(tw["item_table"], tw["item_tower"], ids, fmt, model["tower_residual"])


def ranker(params: Dict, u: torch.Tensor, v: torch.Tensor, model: Dict,
           fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """DCN over ``[u | v]`` and the two heads -> (rating, ctr logit).
    The cross input and output are rounded to ``fmt``; the cross layers
    ``x_{l+1} = x0 (x_l . w_l) + b_l + x_l`` run in fp32; the deep branch
    takes ``fmt`` operands with relu on every layer; the heads are fp32."""
    x0 = rnd(torch.cat([u, v], dim=-1), fmt)
    xc = rnd(x0, fmt)
    xl = xc
    cross = params["dcn"]["cross"]
    for i in range(model["cross_layers"]):
        p = cross[f"layer_{i}"]
        xl = xc * (xl @ p["w"])[:, None] + p["b"] + xl
    xl = rnd(xl, fmt)
    deep = mlp(params["dcn"]["deep"], x0, fmt, final_relu=True)
    h = torch.cat([xl, deep], dim=-1)
    rating = dense(params["rating_head"], h, None)[:, 0]
    ctr = dense(params["ctr_head"], h, None)[:, 0]
    return rating, ctr


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


# ---- training ---------------------------------------------------------

def _softmax_ce_grads(u: torch.Tensor, v: torch.Tensor, corr: torch.Tensor,
                      ids: torch.Tensor, x_emb: torch.Tensor, x_corr: torch.Tensor,
                      x_ids: torch.Tensor, rows: int) -> Tuple[float, torch.Tensor,
                                                             torch.Tensor, torch.Tensor]:
    """Mean over the B rows of the in-batch softmax cross-entropy (row i's
    positive in column i, ``corr`` added per column, columns whose id
    equals row i's off the diagonal at -1e9) over the B in-batch columns
    and the fixed extra columns ``x_*``; computed ``rows`` query rows at a
    time, so the logits never exist whole -> (loss, dL/du, dL/dv,
    dL/dcorr)."""
    b = u.shape[0]
    u_l = u.detach().requires_grad_(True)
    v_l = v.detach().requires_grad_(True)
    c_l = corr.detach().requires_grad_(True)
    cand_ids = torch.cat([ids, x_ids])
    total = 0.0
    for r0 in range(0, b, rows):
        r1 = min(r0 + rows, b)
        cand = torch.cat([v_l, x_emb])
        ccorr = torch.cat([c_l, x_corr])
        logits = u_l[r0:r1] @ cand.T + ccorr[None, :]
        col = torch.arange(cand.shape[0], device=u.device)
        diag = torch.arange(r0, r1, device=u.device)
        hit = (ids[r0:r1, None] == cand_ids[None, :]) & (col[None, :] != diag[:, None])
        logits = torch.where(hit, torch.full_like(logits, NEG_BIG), logits)
        pos = logits[torch.arange(r1 - r0, device=u.device), diag]
        loss = torch.sum(torch.logsumexp(logits, dim=-1) - pos) / b
        loss.backward()
        total += float(loss.detach())
        del logits, hit, pos, loss
    return total, u_l.grad, v_l.grad, c_l.grad


def loss_and_grads(params: Dict, batch: Dict[str, torch.Tensor], model: Dict,
                   cw: Tuple[float, float], cache, fmt: str, rows: int):
    """The multi-task loss of one batch and the gradient of every leaf
    (tables dense) -> (loss, {path: grad}, (item embeddings, corr) for the
    cache). ``cache`` is (emb, ids, corr) or None."""
    leaves = _leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
        p.grad = None
    mid = batch["movie_id"].long()
    u = user_tower(params, batch["user_id"], model, fmt)
    v = item_tower(params, mid, model, fmt)
    rating, ctr = ranker(params, u, v, model, fmt)
    tw = params["towers"]
    bias = tw["item_bias"][mid.clamp(0, tw["item_bias"].shape[0] - 1)]
    corr = bias - batch["log_q"]
    ur, vr = rnd(u, fmt), rnd(v, fmt)
    if cache is None:
        x_emb = u.new_zeros((0, u.shape[1]))
        x_ids = mid.new_zeros((0,)).int()
        x_corr = u.new_zeros((0,))
    else:
        x_emb, x_ids, x_corr = cache
        x_emb = _quantize(x_emb, fmt)
    retr, gu, gv, gc = _softmax_ce_grads(ur, vr, corr, mid.int(), x_emb, x_corr,
                                         x_ids.int(), rows)
    mse = torch.mean(torch.square(rating - batch["rating"]))
    y = batch["y_implicit"]
    per = torch.clamp(ctr, min=0) - ctr * y + torch.log1p(torch.exp(-torch.abs(ctr)))
    w = torch.where(y >= 0.5, torch.full_like(per, cw[0]), torch.full_like(per, cw[1]))
    bce = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-6)
    reg_leaves = [p["w"] for p in params["dcn"]["deep"].values()]
    for t in ("user_tower", "item_tower"):
        reg_leaves += [p["w"] for p in tw[t].values()]
    reg = model["l2_reg"] * sum(torch.sum(torch.square(x)) for x in reg_leaves)
    rest = model["rating_weight"] * mse + model["ctr_weight"] * bce + reg
    rw = model["retrieval_weight"]
    torch.autograd.backward([rest, ur, vr, corr], [None, rw * gu, rw * gv, rw * gc])
    loss = rw * retr + float(rest.detach())
    grads = {path: (p.grad if p.grad is not None else torch.zeros_like(p))
             for path, p in leaves}
    for _, p in leaves:
        p.grad = None
        p.requires_grad_(False)
    with torch.no_grad():
        new_emb = item_tower(params, mid, model, fmt)
        new_corr = (tw["item_bias"][mid] - batch["log_q"])
    return loss, grads, (new_emb, mid.int(), new_corr)


RANKING_KEYS = ("dcn", "rating_head", "ctr_head")


def clip_scale(grads: Dict, clipnorm: float) -> float:
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.double()))) for g in grads.values()))
    return min(1.0, clipnorm / max(norm, 1e-12)) if clipnorm > 0 else 1.0


@torch.no_grad()
def adagrad_step(params: Dict, accum: Dict, grads: Dict, step: int, train: Dict) -> None:
    """Global-norm clip, then ``a += g^2; p -= lr * g / (sqrt(a) + 1e-7)``
    with the ranking learning rate on the DCN and the heads; in place."""
    scale = clip_scale(grads, train["clipnorm"])
    lr = float(np.float32(train["learning_rate"]) * np.float32(0.96) ** np.floor(step / 1000))
    ratio = train["learning_rate_ranking"] / train["learning_rate"]
    for path, p in _leaves(params):
        g = grads[path] * scale
        a = _get(accum, path)
        a.add_(torch.square(g))
        s = ratio if any(k in RANKING_KEYS for k in path) else 1.0
        p.sub_((lr * s) * g / (torch.sqrt(a) + 1e-7))


def _leaves(tree, prefix=()):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


ACCUM0 = 0.1


def follow_steps(params: Dict, batches: List[Dict[str, torch.Tensor]], model: Dict,
                 train: Dict, cache_rows: int, fmt: str = "bf16",
                 rows: int = 4096) -> Dict:
    """Three (or len(batches)) training steps from ``params`` (changed in
    place) -> the readings the check compares: each step's loss, each
    leaf's first gradient norm as Adagrad's slot holds it after step 1,
    and each leaf's change after the last step; besides, each leaf's exact
    first gradient (clipped), which decides the leaves that move."""
    p0 = _map(params, lambda t: t.clone())
    accum = _map(params, lambda t: torch.full_like(t, ACCUM0))
    cache = None
    if cache_rows:
        p = params["towers"]["item_table"]
        cache = (p.new_zeros((cache_rows, p.shape[1])),
                 torch.full((cache_rows,), -1, dtype=torch.int32, device=p.device),
                 torch.full((cache_rows,), NEG_BIG, device=p.device))
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for step, batch in enumerate(batches):
        loss, grads, (emb, ids, corr) = loss_and_grads(params, batch, model, train["cw"],
                                                       cache, fmt, rows)
        out["loss"].append(loss)
        if step == 0:
            scale = clip_scale(grads, train["clipnorm"])
            out["exact_grad_norm"] = {"/".join(p): scale * float(torch.linalg.vector_norm(
                g.double())) for p, g in grads.items()}
        adagrad_step(params, accum, grads, step, train)
        del grads
        if cache is not None:
            n = emb.shape[0]
            cache = (torch.cat([cache[0][n:], emb]), torch.cat([cache[1][n:], ids]),
                     torch.cat([cache[2][n:], corr]))
        if step == 0:
            out["grad_norm"] = slot_norms(accum)
    out["change_norm"] = change_norms(params, p0)
    return out


@torch.no_grad()
def slot_norms(accum: Dict) -> Dict[str, float]:
    """Each leaf's gradient norm worked out from Adagrad's slot after one
    step: sqrt(sum(a - a0)), in fp64 over the fp32 slot."""
    a0 = float(torch.tensor(ACCUM0, dtype=torch.float32))
    return {"/".join(p): math.sqrt(max(float(torch.sum(a.double() - a0)), 0.0))
            for p, a in _leaves(accum)}


@torch.no_grad()
def change_norms(params: Dict, p0: Dict) -> Dict[str, float]:
    return {"/".join(p): float(torch.linalg.vector_norm((a - _get(p0, p)).double()))
            for p, a in _leaves(params)}
