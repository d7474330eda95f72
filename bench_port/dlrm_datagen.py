"""DLRM-DCNv2's inputs and weights from the seed, made on the device in
bulk (a configuration's ``data`` and ``model`` sections; the assumptions
are its ``assumed`` entries).

* dense features: ``log(1 + x)`` of exponential draws of mean 1;
* ids: each bag's first id Zipf(``first_id_zipf``) over its table's rows
  (a shuffled ranking), the bag's other ids uniform over the table;
* labels: Bernoulli of a logistic model of the dense features and of the
  first ids of three tables, at about ``positive_rate`` positives;
* weights: each table uniform in +-sqrt(1 / its published rows) from a
  generator of its own (so one table's initial rows can be drawn again
  alone), the dense kernels Glorot-uniform, biases zero.

The same seed on the same kind of device gives the same inputs and
weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

MIX = 1_000_003


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * MIX + stream) % (1 << 63))


def offsets(model: Dict) -> List[int]:
    """Each table's first row in the concatenated table, then the total."""
    out = [0]
    for r in model["table_rows"]:
        out.append(out[-1] + r)
    return out


def _zipf(gen: torch.Generator, rows: int, n: int, exponent: float, device) -> torch.Tensor:
    """``n`` draws of Zipf(``exponent``) ranks over ``rows``, each rank
    mapped to a row by a random permutation."""
    w = torch.arange(1, rows + 1, dtype=torch.float64, device=device) ** -exponent
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=device)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=rows - 1)
    return torch.randperm(rows, generator=gen, device=device)[rank]


@torch.no_grad()
def batches(seed: int, config: Dict, n: int, device) -> Dict[str, torch.Tensor]:
    """``n`` training rows: {"dense" [n, dense_in] fp32, "sparse" [n, S]
    int32 (the bags side by side, ids local to their tables), "label" [n]
    fp32 0/1}."""
    model, data = config["model"], config["data"]
    gen = _gen(seed, 1, device)
    dense = torch.log1p(torch.empty((n, model["dlrm_dense_in"]), device=device)
                        .exponential_(1.0, generator=gen))
    cols, firsts = [], []
    for rows, h in zip(model["table_rows"], model["bag_sizes"]):
        first = _zipf(gen, rows, n, data["first_id_zipf"], device)
        firsts.append(first)
        cols.append(first[:, None])
        if h > 1:
            cols.append(torch.randint(0, rows, (n, h - 1), generator=gen, device=device))
    sparse = torch.cat(cols, dim=1).to(torch.int32)
    # a logistic model: dense features, and a hash of three tables' first ids
    w = torch.randn((model["dlrm_dense_in"],), generator=gen, device=device)
    z = (dense - dense.mean(0)) @ w * (0.5 / math.sqrt(model["dlrm_dense_in"]))
    for first in firsts[:3]:
        z = z + torch.frac(first.double() * 0.6180339887498949).float() - 0.5
    rate = data["positive_rate"]
    z = z + math.log(rate / (1.0 - rate))
    label = (torch.rand((n,), generator=gen, device=device) < torch.sigmoid(z)).float()
    return {"dense": dense, "sparse": sparse, "label": label}


def table_bounds(model: Dict) -> List[float]:
    return [(1.0 / r) ** 0.5 for r in model.get("table_init_rows") or model["table_rows"]]


@torch.no_grad()
def initial_table(seed: int, model: Dict, t: int, device) -> torch.Tensor:
    """Table ``t``'s initial rows [rows_t, D], drawn again alone."""
    lim = table_bounds(model)[t]
    out = torch.empty((model["table_rows"][t], model["embedding_dim"]), device=device)
    return out.uniform_(-lim, lim, generator=_gen(seed, 100 + t, device))


def dense_shapes(model: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of every dense leaf, in a fixed order (the port's
    layout: ``w`` [in, out])."""
    d = model["embedding_dim"]
    f = (1 + len(model["table_rows"])) * d
    out = []
    dims = [model["dlrm_dense_in"], *model["bottom_mlp_dims"]]
    for i in range(len(dims) - 1):
        out += [(("bottom_mlp", f"layer_{i}", "w"), (dims[i], dims[i + 1])),
                (("bottom_mlp", f"layer_{i}", "b"), (dims[i + 1],))]
    r = model["dcn_low_rank_dim"]
    for i in range(model["cross_layers"]):
        out += [(("cross", f"layer_{i}", "v"), (f, r)), (("cross", f"layer_{i}", "w"), (r, f)),
                (("cross", f"layer_{i}", "b"), (f,))]
    dims = [f, *model["over_arch_dims"], 1]
    for i in range(len(dims) - 1):
        out += [(("over_arch", f"layer_{i}", "w"), (dims[i], dims[i + 1])),
                (("over_arch", f"layer_{i}", "b"), (dims[i + 1],))]
    return out


@torch.no_grad()
def weights(seed: int, model: Dict, device) -> Dict:
    """The model's params (the port's tree: {"embedding": {"table"},
    "bottom_mlp", "cross", "over_arch"}) on ``device``."""
    off = offsets(model)
    table = torch.empty((off[-1], model["embedding_dim"]), device=device)
    for t in range(len(model["table_rows"])):
        table[off[t]:off[t + 1]] = initial_table(seed, model, t, device)
    params: Dict = {"embedding": {"table": table}}
    gen = _gen(seed, 2, device)
    for path, shape in dense_shapes(model):
        if len(shape) == 1:
            leaf = torch.zeros(shape, device=device)
        else:
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            leaf = torch.rand(shape, generator=gen, device=device) * (2 * lim) - lim
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return params
