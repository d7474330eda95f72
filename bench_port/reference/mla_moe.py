"""DeepSeek-V2's MLA and DeepSeekMoE blocks as a sequential recommender, and
its training step, in plain PyTorch, fp32 (TF32 off), with no kernel,
layout, dispatch or batching of the program's: the plain reference of the
``dsv2lite-seqrec-ep8-l4096`` configuration, and of the port's tests.

Written from the equations of DeepSeek-V2 (arXiv:2405.04434, sections 2.1
and 2.2) and the DeepSeek-V2-Lite ``config.json``: with d the hidden width,
H heads, every norm an RMSNorm with a learned scale (eps ``rms_eps``) and a
history of n events (item ids),

* input ``h = item_table[ids]``;
* each layer ``h' = h + MLA(RMSNorm(h))``, ``h'' = h' + FFN(RMSNorm(h'))``;
* MLA of x: ``q = x W_q`` (H heads of nope + rope), ``[c, k_r] = x W_kv_a``,
  ``[k_n, v] = RMSNorm_kv(c) W_kv_b``; head h's query ``[q_n,h, RoPE(q_r,h)]``
  and key ``[k_n,h, RoPE(k_r)]``; ``o_h = softmax(tau q_h k_h^T, causal) v_h``;
  the output ``concat_h o_h W_o``. RoPE rotate-half at the event's index in
  its history, YaRN's frequencies ``g_i r_i + f_i (1 - r_i)`` (f_i =
  theta^(-2i / rope), g_i = f_i / factor, r_i the ramp between
  floor(corr(beta_fast)) and ceil(corr(beta_slow))), the cos and sin times
  mscale(factor, mscale) / mscale(factor, mscale_all_dim), and tau = (nope
  + rope)^-1/2 mscale(factor, mscale_all_dim)^2, mscale(s, m) = 0.1 m ln s
  + 1;
* FFN: a dense SwiGLU ``(silu(x W_gate) * x W_up) W_down`` in the first
  ``mla_dense_layers``; then the shared experts' SwiGLU plus ``sum_{e in T_t,
  e held} s_te SwiGLU_e(x_t)``, ``s_t = softmax(x_t W_g)`` in fp32 over every
  expert, T_t its greedy top-k (the weights not renormalised; the experts
  of other cards left out, as the program leaves them out); the balance
  loss ``alpha mean_b sum_e f_be P_be``, f_be = X / (k n_b) #{t in b: e in
  T_t}, P_be = mean_{t in b} s_te, summed over the MoE layers;
* output: a final RMSNorm, then L2 normalisation;
* loss: at every event i with a next event, ``cos(output_i, item_{i+1}) /
  temperature`` against the K given negatives' cosines (a negative equal
  to the positive left out), ``logsumexp - positive``, the mean over those
  events of the batch; plus the balance losses;
* Adam on every leaf (as ``reference/hstu.py``), its learning rate
  warmed up linearly over the first ``warmup_steps`` (``lr (t + 1) /
  warmup`` at step t), as the program's schedule does.

Each history is padded to its group's longest and its scores [S, H, L, L]
materialised, a group of histories at a time (``PAIRS_BUDGET`` padded
pairs and heads, ``EVENTS_BUDGET`` events), each group's loss taken back
through autograd on its own (the loss and the balance loss are sums over
histories).

The program's expert choices and negatives are given. :func:`follow_steps`
holds the negatives to uniform draws in range, and every program choice
T_t to the reference's own top-k: at the first step, from the same
weights, a choice that differs is allowed only where every expert the
program chose scores, in the reference, within ``TIE`` of the
reference's k-th score (so the reference's k-th and (k+1)-th lie that
close too: the token is a tie; every other token must choose the
reference's own top-k); at every step the tokens whose choice differs are
counted, and at the first the ties.
Then the reference computes its own gate weights at the program's
experts.

Departures from the source, each the configuration's: the vocabulary and
LM head are the item table and the sampled softmax; HF's de-interleaving of
the rope columns before the rotation is left out (with seeded weights, a
fixed permutation of W_q's and W_kv_a's rope columns); ``fmt`` rounds the
operands of every matrix product but the router's, forward and backward
(the incoming gradient too), to bf16 with fp32 sums, as the program does.
``fmt="fp8"`` is the control (e4m3, one scale a tensor); ``fault`` plants
a fault in the reference itself: "plain_rope" takes RoPE's own frequencies
and tau = (nope + rope)^-1/2, "renorm" renormalises the gate weights of a
token's experts to sum 1, "no_shared" leaves the shared experts out,
"no_balance" leaves the balance loss out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.dlrm import mm
from bench_port.reference.hstu import (ADAM, NORM_EPS, _Bmm, change_norms, clone_params,
                                       leaves)

PAIRS_BUDGET = 1 << 27   # padded pairs times heads of a group: its fp32 scores 512 MiB
EVENTS_BUDGET = 8192     # events of a group
# a choice of the program's may differ from the reference's top-k only where
# each expert it chose scores, in the reference, within this share of the
# reference's k-th score: above the widest shortfall the bf16 operands
# upstream of the router have shown (3.5%, at the first step of the
# mlamoe-train-longseq cell), under the faults' (a 7th expert 10% short)
TIE = 5e-2
# negatives: how far a statistic may stray, in standard deviations, and the
# bins of their histogram (as the HSTU cell's)
DRAW_SIGMAS = 8.0
DRAW_BINS = 64


def yarn_mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_tables(model: Dict, n: int, device, fault: str = ""):
    """(cos, sin) [n, rope] at positions 0..n-1."""
    dim, base = model["mla_rope_dim"], model["rope_theta"]
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    f = 1.0 / base ** (i / dim)
    scale = 1.0
    if fault != "plain_rope":
        def corr(b):
            return dim * math.log(model["yarn_original_max"] / (b * 2 * math.pi)) / (
                2 * math.log(base))

        lo = max(math.floor(corr(model["yarn_beta_fast"])), 0)
        hi = min(math.ceil(corr(model["yarn_beta_slow"])), dim - 1)
        hi = hi + 0.001 if hi == lo else hi
        r = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - lo) / (hi - lo), 0, 1)
        f = f / model["yarn_factor"] * r + f * (1 - r)
        scale = yarn_mscale(model["yarn_factor"], model["yarn_mscale"]) / yarn_mscale(
            model["yarn_factor"], model["yarn_mscale_all_dim"])
    ang = torch.outer(torch.arange(n, dtype=torch.float64), f)
    ang = torch.cat([ang, ang], dim=1)
    return ((ang.cos() * scale).float().to(device), (ang.sin() * scale).float().to(device))


def tau(model: Dict, fault: str = "") -> float:
    t = (model["mla_nope_dim"] + model["mla_rope_dim"]) ** -0.5
    if fault == "plain_rope":
        return t
    m = yarn_mscale(model["yarn_factor"], model["yarn_mscale_all_dim"])
    return t * m * m


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _swiglu(p, x, fmt):
    return mm(F.silu(mm(x, p["gate"]["w"], fmt)) * mm(x, p["up"]["w"], fmt), p["down"]["w"], fmt)


def _attention(p, model, x, valid, cos, sin, fmt, fault):
    """MLA of the normed rows x [S, L, d] of S padded histories."""
    s_, l_, d = x.shape
    h, nope, rp = model["mla_heads"], model["mla_nope_dim"], model["mla_rope_dim"]
    kv, vd = model["mla_kv_rank"], model["mla_v_dim"]
    flat = x.reshape(-1, d)
    q = mm(flat, p["q"]["w"], fmt).reshape(s_, l_, h, nope + rp)
    ckr = mm(flat, p["kv_a"]["w"], fmt)
    c, k_r = ckr[:, :kv], ckr[:, kv:].reshape(s_, l_, rp)
    kvb = mm(_rms(c, p["kv_norm"]["scale"], model["rms_eps"]), p["kv_b"]["w"], fmt)
    kvb = kvb.reshape(s_, l_, h, nope + vd)
    cq, sq = cos[None, :, None, :], sin[None, :, None, :]
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cq, sq)], dim=3)
    k_r = _rope(k_r, cos[None], sin[None])
    k = torch.cat([kvb[..., :nope], k_r[:, :, None, :].expand(s_, l_, h, rp)], dim=3)
    v = kvb[..., nope:]

    def heads(t):
        return t.transpose(1, 2).reshape(s_ * h, l_, t.shape[-1])

    scores = _Bmm.apply(heads(q), heads(k).transpose(1, 2), fmt).reshape(s_, h, l_, l_)
    i = torch.arange(l_, device=x.device)
    mask = (i[None, :] <= i[:, None])[None] & valid[:, None, :]
    scores = torch.where(mask[:, None], scores * tau(model, fault), -math.inf)
    prob = torch.softmax(scores, dim=3)
    o = _Bmm.apply(prob.reshape(s_ * h, l_, l_), heads(v), fmt)
    o = o.reshape(s_, h, l_, vd).transpose(1, 2).reshape(-1, h * vd)
    return mm(o, p["o"]["w"], fmt).reshape(s_, l_, d)


def _moe(p, model, x, valid, choice, fmt, fault):
    """The shared experts and the held routed experts over the normed rows
    x [S, L, d] at the program's choices ``choice`` [S, L, k] -> (y [S, L,
    d], the group's balance loss summed over its histories)."""
    s_, l_, d = x.shape
    n_exp, k = model["moe_experts"], model["moe_top_k"]
    flat, ch = x.reshape(-1, d), choice.reshape(-1, k)
    vmask = valid.reshape(-1)
    scores = torch.softmax(flat @ p["router"]["w"], dim=1)
    gates = torch.gather(scores, 1, ch)
    if fault == "renorm":
        gates = gates / gates.sum(dim=1, keepdim=True)
    y = torch.zeros_like(flat)
    ex = p["experts"]
    for e in range(model["moe_experts_held"]):
        hit = (ch == e) & vmask[:, None]
        tok = torch.nonzero(hit.any(dim=1)).reshape(-1)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        out = mm(F.silu(mm(xe, ex["gate"][e], fmt)) * mm(xe, ex["up"][e], fmt), ex["down"][e],
                 fmt)
        w = torch.sum(torch.where(hit[tok], gates[tok], torch.zeros_like(gates[tok])), dim=1)
        y = y.index_add(0, tok, w[:, None] * out)
    if "shared" in p and fault != "no_shared":
        y = y + _swiglu(p["shared"], flat, fmt)
    n = valid.sum(dim=1).double()
    hits = torch.zeros((flat.shape[0], n_exp), dtype=torch.float64, device=x.device)
    hits.scatter_(1, ch, 1.0)
    hits = hits * vmask[:, None]
    f = hits.reshape(s_, l_, n_exp).sum(dim=1) * (n_exp / k) / n[:, None]
    pm = (scores.double() * vmask[:, None]).reshape(s_, l_, n_exp).sum(dim=1) / n[:, None]
    bal = model["moe_aux_alpha"] * torch.sum(f * pm)
    return y.reshape(s_, l_, d), bal.float()


def _groups(lengths: List[int], heads: int) -> List[range]:
    """Consecutive histories within the budgets (one at least)."""
    out, first = [], 0
    for s in range(1, len(lengths) + 1):
        if s < len(lengths):
            grp = lengths[first:s + 1]
            if (len(grp) * max(grp) ** 2 * heads <= PAIRS_BUDGET
                    and sum(grp) <= EVENTS_BUDGET):
                continue
        out.append(range(first, s))
        first = s
    return out


def group_loss_sum(params: Dict, model: Dict, batch: Dict, seqs: range, fmt: str = "bf16",
                   fault: str = "") -> torch.Tensor:
    """The sum of the loss over the supervised events of histories ``seqs``
    of ``batch``, plus their balance losses times the batch's supervised
    events over its histories (so that the batch's sum over groups, over
    its supervised events, is the program's objective)."""
    dev = params["item_table"].device
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
    items = batch["items"].long()[idx]
    cos, sin = rope_tables(model, l_, dev, fault)
    eps = model["rms_eps"]
    h = params["item_table"][items] * valid[:, :, None]
    bal = torch.zeros((), device=dev)
    for i in range(model["mla_layers"]):
        p = params[f"layer_{i}"]
        h = h + _attention(p, model, _rms(h, p["attn_norm"]["scale"], eps), valid, cos, sin, fmt,
                           fault)
        x = _rms(h, p["ffn_norm"]["scale"], eps)
        if i < model["mla_dense_layers"]:
            y = _swiglu(p["mlp"], x.reshape(-1, x.shape[-1]), fmt).reshape(x.shape)
        else:
            y, b = _moe(p, model, x, valid, batch["experts"][i][idx], fmt, fault)
            bal = bal + b
        h = h + y
    h = _rms(h, params["final_norm"]["scale"], eps)
    out = h / torch.clamp(torch.linalg.vector_norm(h, dim=2, keepdim=True), min=NORM_EPS)
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
        neg = batch["draws"]["negatives"][sup_starts[s]:sup_starts[s + 1]]
        lp = torch.sum(qv * table_n[pos_ids], dim=1) / t
        ln = torch.einsum("mkd,md->mk", table_n[neg], qv) / t
        ln = torch.where(neg == pos_ids[:, None], -float("inf"), ln)
        total = total + torch.sum(torch.logsumexp(torch.cat([lp[:, None], ln], dim=1), dim=1)
                                  - lp)
    if fault != "no_balance":
        m = sum(lengths) - len(lengths)
        total = total + bal * (max(m, 1) / len(lengths))
    return total


@torch.no_grad()
def reference_choices(params: Dict, model: Dict, batch: Dict, fmt: str = "bf16"):
    """The reference's own router scores at every MoE layer, following the
    program's choices -> {layer: scores [events, experts]}."""
    dev = params["item_table"].device
    lengths = [int(n) for n in batch["lengths"]]
    starts = np.concatenate([[0], np.cumsum(lengths)])
    out = {}
    eps = model["rms_eps"]
    for seqs in _groups(lengths, model["mla_heads"]):
        ls = [lengths[s] for s in seqs]
        l_ = max(ls)
        rows = torch.full((len(ls), l_), -1, dtype=torch.int64)
        for r, s in enumerate(seqs):
            rows[r, :lengths[s]] = torch.arange(starts[s], starts[s] + lengths[s])
        rows = rows.to(dev)
        valid = rows >= 0
        idx = rows.clamp(min=0)
        cos, sin = rope_tables(model, l_, dev)
        h = params["item_table"][batch["items"].long()[idx]] * valid[:, :, None]
        for i in range(model["mla_layers"]):
            p = params[f"layer_{i}"]
            h = h + _attention(p, model, _rms(h, p["attn_norm"]["scale"], eps), valid, cos, sin,
                               fmt, "")
            x = _rms(h, p["ffn_norm"]["scale"], eps)
            if i < model["mla_dense_layers"]:
                y = _swiglu(p["mlp"], x.reshape(-1, x.shape[-1]), fmt).reshape(x.shape)
            else:
                s = torch.softmax(x.reshape(-1, x.shape[-1]) @ p["router"]["w"], dim=1)
                sel = valid.reshape(-1)
                got = out.setdefault(i, ([], []))
                got[0].append(rows.reshape(-1)[sel])
                got[1].append(s[sel])
                y, _ = _moe(p, model, x, valid, batch["experts"][i][idx], fmt, "")
            h = h + y
    res = {}
    for i, (r, v) in out.items():
        res[i] = torch.cat(v)[torch.argsort(torch.cat(r))]
    return res


def choices_fault(program: Dict[int, torch.Tensor], ref: Dict[int, torch.Tensor], k: int,
                  strict: bool = True):
    """-> (fault or "", tokens whose choice differs, tokens checked, the
    widest shortfall of a chosen expert's reference score under the
    reference's k-th, relative to the k-th, where a choice differs, at the
    strict step, the ties at the strict step): each program choice
    [events, k] is held to the top-k of the reference's scores [events,
    experts] as a set. With ``strict`` (both at the same params: the first
    step) a token is a tie where the reference's k-th and (k+1)-th scores
    lie within ``TIE`` of the k-th; only a tie may choose otherwise, and
    only experts within ``TIE`` of the k-th; after an update the two follow
    their own params, and the differing tokens are only counted."""
    differs, checked, worst, ties = 0, 0, 0.0, 0
    for layer, scores in ref.items():
        chose = program[layer].to(scores.device).long()
        prog = torch.sort(chose, dim=1).values
        top = torch.topk(scores, min(k + 1, scores.shape[1]), dim=1)
        kth = top.values[:, k - 1]
        own = torch.sort(top.indices[:, :k], dim=1).values
        differ = torch.any(prog != own, dim=1)
        checked += int(differ.numel())
        differs += int(differ.sum())
        if not strict:
            continue
        tie = ((kth - top.values[:, -1]) / kth <= TIE) if top.values.shape[1] > k else (
            torch.zeros_like(differ))
        ties += int(tie.sum())
        least = torch.gather(scores, 1, chose).min(dim=1).values
        short = (kth - least) / kth
        if bool(differ.any()):
            worst = max(worst, float(short[differ].max()))
        bad = differ & (~tie | (short > TIE))
        if bool(bad.any()):
            t = int(torch.nonzero(bad)[0])
            return (f"layer {layer} token {t}: the program chose {prog[t].tolist()}, the "
                    f"reference's top-{k} is {own[t].tolist()} (its top-{k + 1} scores "
                    f"{top.values[t].tolist()} at {top.indices[t].tolist()}; the chosen score "
                    f"{scores[t, chose[t]].tolist()})"), differs, checked, worst, ties
    return "", differs, checked, worst, ties


def negatives_fault(neg: torch.Tensor, items: int) -> str:
    """Negatives in 1..items with a histogram over ``DRAW_BINS`` bins of
    ids whose chi-square lies within ``DRAW_SIGMAS`` deviations of its mean
    under uniform draws, or what is wrong."""
    neg = neg.reshape(-1).long().cpu()
    if neg.numel() == 0:
        return ""
    if int(neg.min()) < 1 or int(neg.max()) > items:
        return f"negatives in [{int(neg.min())}, {int(neg.max())}], want [1, {items}]"
    bins = min(DRAW_BINS, items)
    width = torch.bincount(torch.arange(items) * bins // items, minlength=bins).double()
    want = neg.numel() * width / items
    got = torch.bincount((neg - 1) * bins // items, minlength=bins).double()
    chi2 = float(torch.sum((got - want) ** 2 / want))
    if (chi2 - (bins - 1)) / math.sqrt(2 * max(bins - 1, 1)) > DRAW_SIGMAS:
        return f"negatives' histogram off uniform: chi-square {chi2:.1f} over {bins} bins"
    return ""


def loss_and_grads(params: Dict, model: Dict, batch: Dict, fmt: str = "bf16",
                   fault: str = "") -> torch.Tensor:
    """The batch's mean loss plus its balance loss; each leaf's gradient
    added to its ``.grad``."""
    dev = params["item_table"].device
    batch = dict(batch, items=batch["items"].to(dev),
                 draws={k: v.to(dev) for k, v in batch["draws"].items()},
                 experts={k: v.to(dev) for k, v in batch["experts"].items()})
    lengths = [int(n) for n in batch["lengths"]]
    m = sum(lengths) - len(lengths)
    total = 0.0
    for seqs in _groups(lengths, model["mla_heads"]):
        part = group_loss_sum(params, model, batch, seqs, fmt, fault) / max(m, 1)
        part.backward()
        total += float(part.detach())
    return torch.tensor(total)


def adam_steps(params: Dict, model: Dict, train: Dict, batches: List[Dict], fmt: str = "bf16",
               fault: str = "", check: Optional[Dict] = None) -> Dict:
    """Adam over ``batches`` from ``params`` (updated in place) -> {"loss":
    [per step], "grad_norm": {leaf: the first step's gradient norm}}. With
    ``check``, each step's expert choices are first held to the reference's
    own at that step's params (:func:`choices_fault`, strict at the first
    step): ``check``'s "differ" and "tokens" gain each step's tokens whose
    choice differs and those checked, its "ties" the first step's ties and
    its "fault" the first fault, where the steps stop."""
    b1, b2, eps = ADAM
    warmup = train.get("warmup_steps", 0)
    flat = leaves(params)
    slots = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in flat.items()}
    out = {"loss": [], "grad_norm": {}}
    dev = params["item_table"].device
    for step, batch in enumerate(batches):
        if check is not None:
            on = dict(batch, items=batch["items"].to(dev),
                      experts={k: v.to(dev) for k, v in batch["experts"].items()})
            fault_, differ, tokens, worst, ties = choices_fault(
                on["experts"], reference_choices(params, model, on, fmt), model["moe_top_k"],
                strict=step == 0)
            check["differ"].append(differ)
            check["tokens"].append(tokens)
            check["worst_shortfall"] = max(check.get("worst_shortfall", 0.0), worst)
            check["ties"] = check.get("ties", 0) + ties
            if fault_:
                check["fault"] = f"step {step}: {fault_}"
                return out
        for v in flat.values():
            v.grad = None
        out["loss"].append(float(loss_and_grads(params, model, batch, fmt, fault)))
        t = np.float32(step) + np.float32(1.0)
        lr = np.float32(train["learning_rate"])
        lr = float(lr * t / np.float32(warmup) if step < warmup else lr)
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
                p.grad = None
    return out


def follow_steps(params0: Dict, batches: List[Dict], model: Dict, train: Dict,
                 fmt: str = "bf16", fault: str = "",
                 check: Optional[Dict] = None) -> Dict:
    """The reference's readings of the checked steps (each batch {"items",
    "lengths", "draws", "experts": {layer: [events, k]}}): each step's loss,
    the first gradient's norm and the change after the last step, a leaf at
    a time (``compare.train_numbers``'s input). With ``check`` a dict, the
    program's draws are held first (:func:`negatives_fault`, and each
    step's choices by :func:`adam_steps`): ``check`` gains {"fault",
    "differ", "tokens"}, and a fault returns {}."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = clone_params(params0)
        if check is not None:
            check.update(fault="", differ=[], tokens=[])
            for batch in batches:
                f = negatives_fault(batch["draws"]["negatives"], model["hstu_items"])
                if f:
                    check["fault"] = f
                    return {}
        out = adam_steps(params, model, train, batches, fmt, fault, check)
        if check is not None and check["fault"]:
            return {}
        out["change_norm"] = change_norms(params, params0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out
