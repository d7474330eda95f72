"""Optimizer core over nested dicts of tensors (the counterpart of
``recsys_tpu/train/optimizer.py``): adagrad and adam with global-norm
clipping, an exponential-decay schedule with staircase and linear warmup,
and the per-subtree learning-rate split of ``learning_rate_ranking``.

Not ``torch.optim``: adagrad's accumulator starts at 0.1 with eps 1e-7,
and clipping scales by ``min(1, max_norm / max(norm, 1e-12))``, as in the
JAX package (``torch.optim.Adagrad`` starts at 0 with eps 1e-10, and
``clip_grad_norm_`` divides by ``norm + 1e-6``).

``update`` changes params and slots **in place** under ``torch.no_grad()``
(where the JAX package donates the old state to the new one,
``TrainConfig.donate_state``), so a step allocates no second copy of the
tables. The step count and the learning rate are host numbers; the
schedule computes in fp32, as the JAX one does on the device.

The sparse (touched-rows-only) table updates follow the JAX package's
``combine_duplicate_rows`` / ``sparse_adagrad_combined`` /
``sparse_lazy_adam_combined``: duplicate ids are summed first, then only
the touched rows of the table and its slots change, in place, with no
host sync and no [V, D] gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]
Path = Tuple[str, ...]


def leaves_with_paths(tree: Any, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(key path, leaf) pairs of a nested dict, in sorted-key order (the
    order of ``jax.tree_util`` leaves of the same dict)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def exponential_decay(lr: float, decay_steps: int = 1000, decay_rate: float = 0.96,
                      staircase: bool = True, warmup_steps: int = 0) -> Schedule:
    def schedule(step: int) -> float:
        s = np.float32(step)
        p = s / np.float32(decay_steps)
        if staircase:
            p = np.floor(p)
        base = np.float32(lr) * np.float32(decay_rate) ** p
        if warmup_steps > 0 and s < warmup_steps:
            base = np.float32(lr) * (s + np.float32(1.0)) / np.float32(warmup_steps)
        return float(base)

    return schedule


# (keys, reduce): the leaves whose last key is in ``keys`` are this rank's
# shards of larger arrays (the row-sharded tables), and ``reduce`` sums a
# squared norm over the ranks that hold the other shards
ShardReduce = Tuple[Tuple[str, ...], Callable[[torch.Tensor], torch.Tensor]]


@torch.no_grad()
def global_norm(grads: Any, shard_reduce: Optional[ShardReduce] = None) -> torch.Tensor:
    """The norm of every leaf together; with ``shard_reduce`` the sharded
    leaves' squared sum is reduced over their ranks before it joins the
    rest's, so every rank takes the norm of the whole arrays."""
    leaves = leaves_with_paths(grads)
    if shard_reduce is None:
        return torch.sqrt(sum(torch.sum(torch.square(g)) for _, g in leaves))
    keys, reduce = shard_reduce
    zero = torch.zeros((), device=leaves[0][1].device)
    sq = [(p[-1] in keys, torch.sum(torch.square(g))) for p, g in leaves]
    return torch.sqrt(sum((q for s, q in sq if not s), zero)
                      + reduce(sum((q for s, q in sq if s), zero)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The global-norm clip's factor, ``min(1, max_norm / max(norm, 1e-12))``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float,
                        shard_reduce: Optional[ShardReduce] = None) -> Any:
    """-> the same tree scaled by :func:`clip_scale` of its global norm."""
    scale = clip_scale(global_norm(grads, shard_reduce), max_norm)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node * scale

    return walk(grads)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Dict[str, Any]]
    # update(grads, state, params, step, shard_reduce=None): params and
    # state change in place; ``shard_reduce`` reaches the clip's norm
    update: Callable[..., None]


def _zeros_like_tree(params, fill: float = 0.0):
    if isinstance(params, dict):
        return {k: _zeros_like_tree(v, fill) for k, v in params.items()}
    return torch.full_like(params, fill).detach()


def _get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def adagrad(schedule: Schedule, initial_accumulator: float = 0.1, eps: float = 1e-7,
            clipnorm: float = 0.0,
            lr_scale_fn: Optional[Callable[[Path], float]] = None) -> Optimizer:
    """``p -= lr * g / (sqrt(a) + eps)`` with ``a += g**2``;
    ``lr_scale_fn(path)`` scales the learning rate per parameter subtree."""

    def init(params):
        return {"accum": _zeros_like_tree(params, initial_accumulator)}

    @torch.no_grad()
    def update(grads, state, params, step: int,
               shard_reduce: Optional[ShardReduce] = None) -> None:
        if clipnorm > 0:
            grads = clip_by_global_norm(grads, clipnorm, shard_reduce)
        lr = schedule(step)
        for path, g in leaves_with_paths(grads):
            a = _get(state["accum"], path)
            p = _get(params, path)
            a.add_(torch.square(g))
            s = lr_scale_fn(path) if lr_scale_fn is not None else 1.0
            p.sub_((lr * s) * g / (torch.sqrt(a) + eps))

    return Optimizer(init, update)


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         clipnorm: float = 0.0,
         lr_scale_fn: Optional[Callable[[Path], float]] = None) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_tree(params), "nu": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step: int,
               shard_reduce: Optional[ShardReduce] = None) -> None:
        if clipnorm > 0:
            grads = clip_by_global_norm(grads, clipnorm, shard_reduce)
        lr = schedule(step)
        t = np.float32(step) + np.float32(1.0)
        mhat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
        vhat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
        for path, g in leaves_with_paths(grads):
            m = _get(state["mu"], path)
            v = _get(state["nu"], path)
            p = _get(params, path)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            s = lr_scale_fn(path) if lr_scale_fn is not None else 1.0
            p.sub_((lr * s) * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps))

    return Optimizer(init, update)


def combine_duplicate_rows(ids: torch.Tensor, row_grads: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum per-occurrence row gradients over duplicate ids (the dense
    scatter-add semantics) with static shapes -> ``(slot_ids [B], combined
    [B, ...], valid [B])``: slot ``s`` with ``valid[s]`` holds the summed
    gradient of id ``slot_ids[s]``, in ascending id order. Invalid tail
    slots carry zero gradients and id 0 (the JAX package gives them
    out-of-range ids and drops them in its scatters; a CUDA scatter would
    fault on those, so the updates below never scatter an invalid slot)."""
    b = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    first = torch.ones(b, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1  # segment index per sorted row
    combined = torch.zeros_like(row_grads).index_add_(0, seg, row_grads[order])
    # every row of a segment carries the segment's id: the writes agree
    slot_ids = torch.zeros_like(sid).scatter_(0, seg, sid)
    valid = torch.arange(b, device=ids.device) < seg[-1] + 1
    return slot_ids, combined, valid


def _touched_rows(slot_ids: torch.Tensor, combined: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (row ids, gradients) with every invalid slot replaced by a copy
    of slot 0 (always valid). The updates then write each touched row's
    new value once, or several times with the same bits, so a plain
    ``index_put_`` stays deterministic, needs no host sync to count the
    valid slots, and never sees an out-of-range id."""
    src = torch.where(valid, torch.arange(valid.shape[0], device=valid.device), 0)
    return slot_ids[src].long(), combined[src]


@torch.no_grad()
def sparse_adagrad_combined(table: torch.Tensor, accum: torch.Tensor,
                            slot_ids: torch.Tensor, combined: torch.Tensor,
                            valid: torch.Tensor, lr: float, eps: float = 1e-7,
                            grad_scale: Optional[torch.Tensor] = None) -> None:
    """Adagrad on the rows of pre-combined unique-row gradients (see
    :func:`combine_duplicate_rows`), ``table`` and ``accum`` in place:
    ``accum[id] += g**2; table[id] -= lr * g / (sqrt(accum[id]) + eps)``,
    the dense update restricted to the touched rows (adagrad does nothing
    to a row with a zero gradient). ``grad_scale`` folds in the caller's
    global-norm clip factor."""
    if grad_scale is not None:
        combined = combined * grad_scale
    rows, g = _touched_rows(slot_ids, combined, valid)
    acc_rows = accum[rows] + torch.square(g)
    accum[rows] = acc_rows
    table[rows] = table[rows] - lr * g / (torch.sqrt(acc_rows) + eps)


@torch.no_grad()
def sparse_rowwise_adagrad_combined(table: torch.Tensor, accum: torch.Tensor,
                                    slot_ids: torch.Tensor, combined: torch.Tensor,
                                    valid: torch.Tensor, lr: float, eps: float = 1e-8) -> None:
    """Row-wise Adagrad (FBGEMM's exact row-wise Adagrad) on the rows of
    pre-combined unique-row gradients, ``table`` [V, D] and its one
    accumulator a row ``accum`` [V] in place: ``accum[id] += mean(g**2);
    table[id] -= lr * g / (sqrt(accum[id]) + eps)``. A row with a zero
    gradient does not move. ``ops/embedding_bag.py`` fuses this update
    into the bags' backward on the card."""
    rows, g = _touched_rows(slot_ids, combined, valid)
    acc_rows = accum[rows] + torch.mean(torch.square(g), dim=1)
    accum[rows] = acc_rows
    table[rows] = table[rows] - lr * g / (torch.sqrt(acc_rows)[:, None] + eps)


@torch.no_grad()
def sparse_adagrad_rows(table: torch.Tensor, accum: torch.Tensor, ids: torch.Tensor,
                        row_grads: torch.Tensor, lr: float, eps: float = 1e-7,
                        grad_scale: Optional[torch.Tensor] = None) -> None:
    """Adagrad on the rows of ``table`` named by per-occurrence ``ids``
    [B] with ``row_grads`` [B, ...]: duplicates summed, then
    :func:`sparse_adagrad_combined`. O(B * D) traffic instead of O(V * D)."""
    slot_ids, combined, valid = combine_duplicate_rows(ids, row_grads)
    sparse_adagrad_combined(table, accum, slot_ids, combined, valid, lr, eps, grad_scale)


@torch.no_grad()
def sparse_lazy_adam_combined(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                              slot_ids: torch.Tensor, combined: torch.Tensor,
                              valid: torch.Tensor, lr: float, step: int,
                              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                              grad_scale: Optional[torch.Tensor] = None) -> None:
    """LAZY Adam on pre-combined unique-row gradients, in place: moments
    and parameters change only on the touched rows; untouched rows keep
    their moments un-decayed (TensorFlow's LazyAdam, a documented
    departure from dense Adam). Bias correction uses the GLOBAL step, as
    the JAX package's ``sparse_lazy_adam_combined`` does."""
    if grad_scale is not None:
        combined = combined * grad_scale
    rows, g = _touched_rows(slot_ids, combined, valid)
    mu_rows = b1 * mu[rows] + (1 - b1) * g
    nu_rows = b2 * nu[rows] + (1 - b2) * g * g
    t = np.float32(step) + np.float32(1.0)
    mhat = mu_rows / float(np.float32(1.0) - np.float32(b1) ** t)
    vhat = nu_rows / float(np.float32(1.0) - np.float32(b2) ** t)
    mu[rows] = mu_rows
    nu[rows] = nu_rows
    table[rows] = table[rows] - lr * mhat / (torch.sqrt(vhat) + eps)


def make_schedule(train_cfg) -> Schedule:
    return exponential_decay(train_cfg.learning_rate, train_cfg.lr_decay_steps,
                             train_cfg.lr_decay_rate, train_cfg.lr_staircase,
                             train_cfg.warmup_steps)


# the ranking stack of the multi-task model: DCN and both heads (the
# retrieval side, tables, towers and item_bias, keeps the base LR)
RANKING_PARAM_KEYS = ("dcn", "rating_head", "ctr_head")


def ranking_lr_scale(train_cfg) -> Optional[Callable[[Path], float]]:
    """Per-leaf LR scale implementing ``learning_rate_ranking``; None when
    the split is off."""
    lrr = train_cfg.learning_rate_ranking
    if lrr is None or lrr == train_cfg.learning_rate:
        return None
    ratio = lrr / train_cfg.learning_rate

    def scale(path: Path) -> float:
        return ratio if any(k in RANKING_PARAM_KEYS for k in path) else 1.0

    return scale


def make_optimizer(train_cfg) -> Optimizer:
    """The configured optimizer of a ``TrainConfig``."""
    sched = make_schedule(train_cfg)
    scale_fn = ranking_lr_scale(train_cfg)
    if train_cfg.optimizer == "adagrad":
        return adagrad(sched, clipnorm=train_cfg.clipnorm, lr_scale_fn=scale_fn)
    if train_cfg.optimizer == "adam":
        return adam(sched, clipnorm=train_cfg.clipnorm, lr_scale_fn=scale_fn)
    raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
