"""MLA-MoE's inputs and weights from the seed (a configuration's ``data`` and
``model`` sections; the assumptions are its ``assumed`` entries).

* history lengths: ``hstu_datagen.lengths`` (the log-normal's quantiles in
  a seeded order: every seed trains the same lengths, so an epoch's events
  and causal pairs do not move with the seed);
* item ids: Zipf(``item_zipf``) ranks over the ``hstu_items`` ids, each
  rank mapped to an id by a seeded permutation, drawn on the device (as
  ``hstu_datagen.histories`` draws them; no timestamps: the model reads
  none);
* weights: every matrix normal with std 0.02 (the source's
  initializer_range), every RMSNorm scale 1, the item table's row 0 (the
  padding row) zero.

The same seed on the same kind of device gives the same inputs and
weights. A history is the benchmark's example.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_port import hstu_datagen

STD = 0.02


@torch.no_grad()
def histories(seed: int, config: Dict, n: int, device) -> Dict[str, torch.Tensor]:
    """``n`` histories, jagged: {"items" [events] int32 on ``device``,
    "lengths" [n] int64 on the host}."""
    data, model = config["data"], config["model"]
    lens = hstu_datagen.lengths(seed, config, n)
    events = int(lens.sum())
    gen = hstu_datagen._gen(seed, 1, device)
    items = model["hstu_items"]
    w = torch.arange(1, items + 1, dtype=torch.float64, device=device) ** -data["item_zipf"]
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((events,), generator=gen, dtype=torch.float64, device=device)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=items - 1)
    ids = torch.randperm(items, generator=gen, device=device)[rank] + 1
    return {"items": ids.to(torch.int32), "lengths": lens}


@torch.no_grad()
def weights(seed: int, model: Dict, device) -> Dict:
    """The initial params (the program's tree: ``models/mla_moe.py``)."""
    gen = hstu_datagen._gen(seed, 2, device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * STD

    def ones(n):
        return {"scale": torch.ones((n,), device=device)}

    d, h = model["embedding_dim"], model["mla_heads"]
    nope, rope, vd, kv = (model["mla_nope_dim"], model["mla_rope_dim"], model["mla_v_dim"],
                          model["mla_kv_rank"])
    table = normal(model["hstu_items"] + 1, d)
    table[0] = 0.0
    out = {"item_table": table, "final_norm": ones(d)}
    for i in range(model["mla_layers"]):
        p = {"attn_norm": ones(d), "q": {"w": normal(d, h * (nope + rope))},
             "kv_a": {"w": normal(d, kv + rope)}, "kv_norm": ones(kv),
             "kv_b": {"w": normal(kv, h * (nope + vd))}, "o": {"w": normal(h * vd, d)},
             "ffn_norm": ones(d)}
        if i >= model["mla_dense_layers"]:
            g, w = model["moe_experts_held"], model["moe_width"]
            s = model["moe_shared"] * w
            p["router"] = {"w": normal(d, model["moe_experts"])}
            if s:
                p["shared"] = {"gate": {"w": normal(d, s)}, "up": {"w": normal(d, s)},
                               "down": {"w": normal(s, d)}}
            p["experts"] = {"gate": normal(g, d, w), "up": normal(g, d, w),
                            "down": normal(g, w, d)}
        else:
            w = model["mla_dense_width"]
            p["mlp"] = {"gate": {"w": normal(d, w)}, "up": {"w": normal(d, w)},
                        "down": {"w": normal(w, d)}}
        out[f"layer_{i}"] = p
    return out
