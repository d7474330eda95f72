"""Two-stage serving in plain PyTorch: the user tower, cosine scores
over the whole catalog (item embeddings worked out from the weights),
the top ``rerank`` candidates by cosine, and the rerank score
``cosine + ctr_weight * CTR logit (+ rating_weight * rating)``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bench_port.reference.model import item_tower, l2_normalize, ranker, user_tower


class Scorer:
    """The reference's view of one model: item embeddings made once,
    then answers and scores for any user."""

    def __init__(self, params: Dict, model: Dict, serve: Dict, n_items: int,
                 fmt: str = "bf16", block: int = 65536):
        self.params, self.model, self.serve, self.fmt = params, model, serve, fmt
        dev = params["towers"]["item_table"].device
        with torch.no_grad():
            ids = torch.arange(n_items, device=dev)
            self.items = torch.cat([item_tower(params, ids[i:i + block], model, fmt)
                                    for i in range(0, n_items, block)])
            self.items_norm = l2_normalize(self.items)

    @torch.no_grad()
    def users(self, uids: torch.Tensor) -> torch.Tensor:
        return user_tower(self.params, uids, self.model, self.fmt)

    @torch.no_grad()
    def cosine(self, u: torch.Tensor) -> torch.Tensor:
        """[Q, n_items] cosine scores."""
        return l2_normalize(u) @ self.items_norm.T

    @torch.no_grad()
    def rerank_score(self, u: torch.Tensor, cos: torch.Tensor, items: torch.Tensor
                     ) -> torch.Tensor:
        """[Q, C] rerank scores of the items ``items`` [Q, C] whose cosine
        is ``cos`` [Q, C]."""
        q, c = items.shape
        uu = u[:, None, :].expand(q, c, u.shape[1]).reshape(q * c, -1)
        vv = self.items[items.reshape(-1)]
        rating, ctr = ranker(self.params, uu, vv, self.model, self.fmt)
        out = cos + self.serve["rerank_ctr_weight"] * ctr.reshape(q, c)
        if self.serve["rerank_rating_weight"]:
            out = out + self.serve["rerank_rating_weight"] * rating.reshape(q, c)
        return out

    @torch.no_grad()
    def answer(self, uids: torch.Tensor, rerank: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (top-k items, their scores, every candidate [Q, rerank], the
        cosine of the rerank-th candidate [Q])."""
        u = self.users(uids)
        cos = self.cosine(u)
        cs, ci = torch.topk(cos, rerank, dim=1)
        score = self.rerank_score(u, cs, ci)
        top, pos = torch.topk(score, k, dim=1)
        return torch.gather(ci, 1, pos), top, ci, cs[:, -1]

    @torch.no_grad()
    def score_items(self, uids: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """[Q, C] rerank scores of given items (any catalog rows)."""
        u = self.users(uids)
        cos = torch.gather(self.cosine(u), 1, items)
        return self.rerank_score(u, cos, items)
