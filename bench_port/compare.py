"""The numbers that decide ``correct``, each against its limit.

Serving: every sampled answer is held against the reference's model.
``score_err`` is the widest gap between a served score and the
reference's score of the same (user, item); ``rank_gap`` the widest gap
by which the served item at rank r scores below the reference's r-th best
candidate, counting only candidates whose cosine lies clearly inside the
retrieval cut (``tie`` above the reference's ``rerank``-th cosine), so a
tie at the cut is no fault; ``bad_answers`` counts answers that never
came, came with an error, or do not hold k distinct catalog items.

Training: ``loss_gap`` is the widest relative gap of a checked step's
loss; ``grad_gap`` and ``change_gap`` the widest gap, over the leaves,
between the program's norm and the reference's (the first gradient as the
optimizer's slot holds it; the parameters' change after the last checked
step), measured against the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose exact reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of ``change_gap``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

TIE = 1e-4  # cosine units: the program's and the reference's cosines differ by ~1e-6


def serve_numbers(scorer, answers: Sequence[Tuple[int, Optional[List[Tuple[int, float]]]]],
                  rerank: int, k: int, n_items: int, tie: float = TIE) -> Dict[str, float]:
    """``answers``: (dense user id, [(dense item id, score)] or None)."""
    bad = 0
    good = []
    for uid, recs in answers:
        items = [i for i, _ in recs] if recs is not None else []
        if (recs is None or len(items) != k or len(set(items)) != k
                or not all(0 <= i < n_items for i in items)):
            bad += 1
            continue
        good.append((uid, items, [s for _, s in recs]))
    out = {"bad_answers": float(bad), "score_err": 0.0, "rank_gap": 0.0}
    if not good:
        return out
    dev = scorer.items.device
    uids = torch.tensor([g[0] for g in good], device=dev)
    items = torch.tensor([g[1] for g in good], device=dev)
    scores = torch.tensor([g[2] for g in good], device=dev, dtype=torch.float64)
    for lo in range(0, len(good), 256):
        sl = slice(lo, lo + 256)
        ref_served = scorer.score_items(uids[sl], items[sl]).double()
        out["score_err"] = max(out["score_err"],
                               float(torch.max(torch.abs(scores[sl] - ref_served))))
        u = scorer.users(uids[sl])
        cos = scorer.cosine(u)
        cs, ci = torch.topk(cos, rerank, dim=1)
        cand = scorer.rerank_score(u, cs, ci)
        inside = cs > cs[:, -1:] + tie
        best = torch.topk(torch.where(inside, cand, torch.full_like(cand, -float("inf"))),
                          k, dim=1).values.double()
        gap = torch.where(torch.isfinite(best), best - ref_served, torch.zeros_like(best))
        out["rank_gap"] = max(out["rank_gap"], float(torch.max(gap)))
    return out


def _median(xs):
    return statistics.median(xs) if xs else 0.0


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, object]:
    """``prog`` and ``ref``: {"loss": [per step], "grad_norm": {leaf: norm},
    "change_norm": {leaf: norm}}."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog["loss"], ref["loss"]))
    gr = ref["grad_norm"]
    med_g = _median(list(gr.values()))
    grad = {k: abs(prog["grad_norm"][k] - g) / max(g, med_g, 1e-30) for k, g in gr.items()}
    exact = ref.get("exact_grad_norm", gr)
    med_e = _median(list(exact.values()))
    moved = [k for k, g in exact.items() if g >= 1e-3 * med_e]
    cr = ref["change_norm"]
    med_c = _median([cr[k] for k in moved])
    change = {k: abs(prog["change_norm"][k] - cr[k]) / max(cr[k], med_c, 1e-30)
              for k in moved}
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g], "change_gap": change[worst_c],
            "worst_grad_leaf": worst_g, "worst_change_leaf": worst_c,
            "left_out": sorted(set(gr) - set(moved))}


def judge(numbers: Dict[str, object], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """-> (every number within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": float(numbers[name]), "limit": float(lim)}
              for name, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
