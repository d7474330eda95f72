"""Inputs and weights from the seed.

The ratings follow the port's smoke bundle (``synthetic_bundle`` in the
repository's ``chip_smoke.py``, copied here so that a change to the
program cannot move the yardstick): users uniform, items Zipf-skewed over
a shuffled ranking, ratings from 8-dim random user and item factors plus
noise. Weights follow the model's own initialisers (Glorot-uniform dense
kernels, zero biases, N(0, 1/d) table rows with one out-of-vocabulary row)
and are drawn on the device from a generator seeded by the seed, in a few
large calls. The same seed gives the same inputs and weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def zipf_items(rng: np.random.Generator, n_items: int, n: int, exponent: float) -> np.ndarray:
    pop = np.arange(1, n_items + 1, dtype=np.float64) ** -exponent
    pop = pop[rng.permutation(n_items)]
    return rng.choice(n_items, n, p=pop / pop.sum()).astype(np.int32)


def ratings(seed: int, data: Dict, n: int) -> Dict[str, np.ndarray]:
    """``n`` rating rows: user_id, movie_id, rating (1..5), y_implicit."""
    rng = _rng(seed, 1)
    users = rng.integers(0, data["n_users"], n).astype(np.int32)
    items = zipf_items(rng, data["n_items"], n, data["item_zipf"])
    k = data["latent_dim"]
    fu = rng.standard_normal((data["n_users"], k), dtype=np.float32)
    fi = rng.standard_normal((data["n_items"], k), dtype=np.float32)
    score = (fu[users] * fi[items]).sum(axis=1) / np.float32(np.sqrt(k))
    noise = rng.standard_normal(n, dtype=np.float32)
    rating = np.clip(np.rint(3.5 + score + 0.5 * noise), 1, 5).astype(np.float32)
    return {"user_id": users, "movie_id": items, "rating": rating,
            "y_implicit": (rating >= 4.0).astype(np.float32)}


def train_split(seed: int, data: Dict, batch: int) -> Dict[str, np.ndarray]:
    """The training rows: the first ``train_frac`` of ``n_ratings`` rows,
    or ``steps_per_epoch`` batches of them."""
    if "steps_per_epoch" in data:
        n = data["steps_per_epoch"] * batch
        return ratings(seed, data, n)
    rows = ratings(seed, data, data["n_ratings"])
    n_train = int(data["n_ratings"] * data["train_frac"])
    return {k: v[:n_train] for k, v in rows.items()}


def log_q_table(movie_id: np.ndarray, n_items: int) -> np.ndarray:
    """log of each item's share of the training rows (0.5 for an unseen one)."""
    pop = np.bincount(movie_id, minlength=n_items).astype(np.float32)
    return np.log(np.maximum(pop, 0.5) / max(len(movie_id), 1)).astype(np.float32)


def class_weights(y: np.ndarray):
    """Balanced class weights ``n / (2 n_c)`` -> (w_pos, w_neg)."""
    n = len(y)
    n_pos = max(float((y >= 0.5).sum()), 1.0)
    return n / (2.0 * n_pos), n / (2.0 * max(n - n_pos, 1.0))


def _dense_shapes(model: Dict):
    """(path, shape) of every dense kernel, in a fixed order."""
    d = model["embedding_dim"]
    f = 2 * d + model.get("dense_features", 0)
    out = []
    for tw, dims in (("user_tower", model["user_tower_dims"]),
                     ("item_tower", model["item_tower_dims"])):
        ds = [d, *dims, d]
        out += [(("towers", tw, f"layer_{i}"), (ds[i], ds[i + 1])) for i in range(len(ds) - 1)]
    out += [(("dcn", "cross", f"layer_{i}"), (f, 1)) for i in range(model["cross_layers"])]
    ds = [f, *model["dnn_dims"]]
    out += [(("dcn", "deep", f"layer_{i}"), (ds[i], ds[i + 1])) for i in range(len(ds) - 1)]
    f_out = f + (model["dnn_dims"][-1] if model["dnn_dims"] else 0)
    out += [(("rating_head",), (f_out, 1)), (("ctr_head",), (f_out, 1))]
    return out


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@torch.no_grad()
def weights(seed: int, model: Dict, n_users: int, n_items: int, device,
            item_bias: np.ndarray = None) -> Dict:
    """The model's parameter tree (the port's layout: dense ``w`` is
    [in, out], cross ``w`` is [F]) drawn on ``device`` from ``seed``:
    one normal draw for both tables, one uniform draw for every kernel.
    ``item_bias`` (fp32 [n_items]) sets the bias rows, the OOV row taking
    their minimum; else zeros."""
    gen = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
    d = model["embedding_dim"]
    rows = torch.randn(((n_users + 1) + (n_items + 1), d), generator=gen,
                       device=device) * (d ** -0.5)
    shapes = _dense_shapes(model)
    sizes = [a * b for _, (a, b) in shapes]
    u = torch.rand((sum(sizes),), generator=gen, device=device)
    params: Dict = {}
    _put(params, ("towers", "user_table"), rows[:n_users + 1].contiguous())
    _put(params, ("towers", "item_table"), rows[n_users + 1:].contiguous())
    for (path, (a, b)), part in zip(shapes, torch.split(u, sizes)):
        lim = (6.0 / (a + b)) ** 0.5
        w = (part * (2 * lim) - lim).reshape(a, b)
        if path[:2] == ("dcn", "cross"):
            _put(params, path, {"w": w[:, 0].contiguous(),
                                "b": torch.zeros((a,), device=device)})
        else:
            _put(params, path, {"w": w, "b": torch.zeros((b,), device=device)})
    bias = torch.zeros((n_items + 1,), device=device)
    if item_bias is not None:
        bias[:n_items] = torch.as_tensor(item_bias, device=device)
        bias[n_items] = float(item_bias.min())
    params["towers"]["item_bias"] = bias
    return params


def leaves(tree: Dict, prefix=()):
    """(path, tensor) of a nested dict in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out
