"""HSTU's inputs and weights from the seed (a configuration's ``data`` and
``model`` sections; the assumptions are its ``assumed`` entries).

* history lengths: the log-normal's quantiles (median ``length_median``,
  sigma ``length_sigma``) at (k + 1/2) / n for the n histories, rounded
  and clipped to [``length_min``, ``hstu_max_len``], in an order drawn
  from the seed on the host: every seed trains the same lengths, so an
  epoch's events and causal pairs do not move with the seed;
* item ids: Zipf(``item_zipf``) ranks over the ``hstu_items`` ids, each
  rank mapped to an id by a seeded permutation, drawn on the device;
* timestamps: a start drawn uniformly in ``start_range`` seconds, then
  gaps log-uniform in [``gap_min_s``, ``gap_max_s``] seconds between a
  user's consecutive events, whole seconds, int64, on the device;
* weights: the item table and position embedding truncated normal (std
  0.02 and sqrt(1 / d), cut at two std; the item table's row 0, the
  padding row, zero), W_uvqk, pos_w and ts_w normal with std 0.02, W_o
  Glorot-uniform, b_o zero.

The same seed on the same kind of device gives the same inputs and
weights. A history is the benchmark's example.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict

import numpy as np
import torch

MIX = 1_000_003
HEAD = 64
NUM_BUCKETS = 128


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * MIX + stream) % (1 << 63))


def lengths(seed: int, config: Dict, n: int) -> torch.Tensor:
    """[n] int64 on the host: the histories' lengths."""
    data, model = config["data"], config["model"]
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)])
    x = np.exp(math.log(data["length_median"]) + data["length_sigma"] * z)
    x = np.clip(np.rint(x), data["length_min"], model["hstu_max_len"]).astype(np.int64)
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    return torch.from_numpy(x[rng.permutation(n)])


@torch.no_grad()
def histories(seed: int, config: Dict, n: int, device) -> Dict[str, torch.Tensor]:
    """``n`` histories, jagged: {"items" [events] int32, "timestamps"
    [events] int64 (ascending within a history) on ``device``, "lengths"
    [n] int64 on the host}."""
    data, model = config["data"], config["model"]
    lens = lengths(seed, config, n)
    events = int(lens.sum())
    gen = _gen(seed, 1, device)
    items = model["hstu_items"]
    w = torch.arange(1, items + 1, dtype=torch.float64, device=device) ** -data["item_zipf"]
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((events,), generator=gen, dtype=torch.float64, device=device)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=items - 1)
    ids = torch.randperm(items, generator=gen, device=device)[rank] + 1
    lo, hi = math.log(data["gap_min_s"]), math.log(data["gap_max_s"])
    gaps = torch.exp(torch.rand((events,), generator=gen, dtype=torch.float64, device=device)
                     * (hi - lo) + lo).round().to(torch.int64)
    s0, s1 = data["start_range"]
    starts = torch.randint(int(s0), int(s1), (n,), generator=gen, device=device)
    lens_d = lens.to(device)
    seq = torch.repeat_interleave(torch.arange(n, device=device), lens_d, output_size=events)
    first = torch.zeros(n, dtype=torch.int64, device=device)
    first[1:] = torch.cumsum(lens_d, 0)[:-1]
    gaps[first] = 0
    cum = torch.cumsum(gaps, 0)
    ts = cum - cum[first][seq] + starts[seq]
    return {"items": ids.to(torch.int32), "timestamps": ts, "lengths": lens}


@torch.no_grad()
def weights(seed: int, model: Dict, device) -> Dict:
    """The initial params (the program's tree: ``models/hstu.py``)."""
    gen = _gen(seed, 2, device)
    d, n = model["embedding_dim"], model["hstu_max_len"]
    w = model["hstu_heads"] * HEAD

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def trunc(shape, std):
        x = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(x, 0.0, std, -2 * std, 2 * std, generator=gen)

    table = trunc((model["hstu_items"] + 1, d), 0.02)
    table[0] = 0.0
    out = {"item_table": table, "pos_emb": trunc((n, d), (1.0 / d) ** 0.5)}
    lim = (6.0 / (w + d)) ** 0.5
    for b in range(model["hstu_blocks"]):
        out[f"block_{b}"] = {
            "uvqk": {"w": normal((d, 4 * w), 0.02)},
            "o": {"w": (torch.rand((w, d), generator=gen, device=device) * 2 - 1) * lim,
                  "b": torch.zeros((d,), device=device)},
            "pos_w": normal((2 * n - 1,), 0.02),
            "ts_w": normal((NUM_BUCKETS + 1,), 0.02),
        }
    return out
