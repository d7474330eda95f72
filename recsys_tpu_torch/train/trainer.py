"""The trainer (the counterpart of ``recsys_tpu/train/trainer.py``): on
one card, or data-parallel over the ``data`` axis of a mesh.

* params and optimizer slots live on the device. On the device-resident
  path (the default) so does the whole train split: an epoch is a loop
  of steps over an on-device permutation, each step a gather of the
  batch, ``MultiTaskModel.loss``, ``torch.autograd.grad`` and the
  optimizer's in-place update (the JAX package's ``make_train_epoch``:
  one compiled scan per epoch; here the Python loop dispatches and the
  metrics stay on the device until the epoch ends);
* the streaming path (``device_resident_data=False``, or a split above
  ``device_data_limit_mb``): the ``Batcher``'s numpy batches, placed by
  ``_prefetch`` two ahead (pinned staging, copies on a side stream),
  ``stream_chunk_steps`` batches per transfer, mid-epoch checkpoints
  every ``checkpoint_every_steps``, an unweighted mean of the val
  batches' metrics;
* explicit negatives (``negative_sampling`` hard, mixed or mined): the
  ``NegativeSampler`` fitted on the train split gives each row K negative
  ids (a fresh ``neg_ids`` column each epoch on the resident path, per
  batch on the streaming path), scored by the loss's explicit softmax;
  they take the dense step, as in the JAX package; "mined" reads
  ``Trainer.mined_table`` or mines ``data.mined_from``;
* sparse table updates (``TrainConfig.sparse_table_updates``; "auto"
  above ``SPARSE_AUTO_THRESHOLD`` table elements): the batch's table rows
  become fresh [B, D] leaves, so autograd returns per-occurrence row
  gradients, and only the touched rows of the tables and their slots
  change (adagrad as the dense step up to summation order, adam as
  LazyAdam);
* the CBNS cross-batch negative cache (``TrainConfig.negative_cache``):
  a FIFO of earlier batches' item embeddings in ``TrainState.extras``,
  appended to the in-batch softmax's candidates, carried through both
  steps, the epoch loop and the checkpoints;
* balanced CTR class weights, the log-frequency logQ table and the
  ``item_bias`` init to it;
* engineered dense features (``ModelConfig.dense_features > 0``): the
  ``FeatureEngineer`` is fitted on the train split on the host, and each
  split's standardized [N, F] fp32 matrix is a ``dense`` column on the
  device, gathered per step like the others and fed to the DCN input; the
  fitted state ships in the inference bundle (``features.npz``);
* a padded, masked validation pass per epoch; early stopping on
  ``val_loss`` (or a periodic sampled ``val_recall@10``) with the best
  weights restored; a checkpoint every epoch and one on SIGTERM/SIGUSR1;
* the final ``evaluate``, then ``RetrievalIndex.build`` and the
  inference bundle in ``<output_dir>/serving``.

**Data-parallel training** (a :class:`MeshContext` of ``(data, 1)``:
given, or made when a launcher's process group has more than one rank):
every rank holds the whole tables and params, takes its ``data`` slice of
each global batch (the one-card run's batches) and ends every step with
the same bits. The step is the explicit form of the JAX package's
``_step_core_spmd`` without the row-sharded lookups: the loss of the
rank's slice, with global negatives (the candidates all-gathered,
differentiably, from every rank) or per-replica ones, and the BCE over
the global weight sum; backward; ONE all-reduce (mean) of every gradient,
in a flat buffer; then the global-norm clip and the optimizer on the
averaged gradients on every rank; the metrics mean-reduced in one call.
The sparse step divides its virtual rows' gradients by the ranks (each
rank's item rows already hold the sum of every rank's cotangent), gathers
them and their ids over ``data`` into the global batch's rows, and every
rank applies the same touched-rows update. The CBNS cache gains the
global batch each step. Validation scores the whole split on every rank
(the one-card values, so early stopping decides alike everywhere); rank 0
writes the logs, checkpoints, final report and bundle while the others
wait at a barrier; a preemption signal is max-reduced over the ranks;
``replication_check_every_epochs`` asserts bitwise-equal params
(``utils/debug.py``). Without a mesh nothing of this runs: no process
group, no collective.

Every mode of the JAX trainer that is not ported raises
``NotImplementedError`` naming its ROADMAP Queue 1 item; none silently runs
something else. Dropout masks come from a ``torch.Generator`` on the
device, reseeded from (seed + 1, step) every step, and from the rank's
data index under a mesh (index 0 draws the one-card stream), so a run and
its resume draw the same masks; they are not JAX's masks.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import signal
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from recsys_tpu_torch.config import RecsysConfig
from recsys_tpu_torch.data.features import make_engineer
from recsys_tpu_torch.data.negative_sampling import NegativeSampler, mine_hard_negatives
from recsys_tpu_torch.data.pipeline import Batcher
from recsys_tpu_torch.models import losses
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.parallel import collectives
from recsys_tpu_torch.parallel.mesh import MeshContext, make_mesh, world_size
from recsys_tpu_torch.parallel.sharding import local_slice
from recsys_tpu_torch.retrieval.evaluator import evaluate
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train import checkpoint as ckpt_lib
from recsys_tpu_torch.train import optimizer as opt_lib
from recsys_tpu_torch.train.optimizer import leaves_with_paths, make_optimizer
from recsys_tpu_torch.utils.debug import assert_replicated
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device
from recsys_tpu_torch.utils.metrics_io import MetricWriter

logger = logging.getLogger(__name__)

METRIC_KEYS = ("loss", "retrieval_loss", "rating_mse", "ctr_bce", "l2")
BATCH_COLUMNS = ("user_id", "movie_id", "rating", "y_implicit")


class TrainState(NamedTuple):
    params: Any      # nested dict of fp32 leaves with requires_grad
    opt_state: Any   # the optimizer's slots, same tree per slot name
    step: int        # a host count
    rng: int         # the dropout seed; masks of a step derive from (rng, step)
    # the CBNS cache {"emb" [N, D], "ids" [N], "corr" [N]} (a FIFO, newest
    # batch last) when TrainConfig.negative_cache > 0, else None
    extras: Any = None


_DEBUG_PROFILE = "item 7, debug and profile"
_ROW_SHARDED = "item 8c, row-sharded tables"
# a large odd constant: data index r adds r times it to the dropout seed
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to recsys_tpu_torch yet (ROADMAP Queue 1: {item})")


def _tree_from_paths(values: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, v in values.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _grads(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaves; a leaf the loss does not reach (item_bias under
    use_item_bias=False) gets a zero gradient, as in JAX."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def _prefetch(iterator, place, depth: int = 2):
    """``place`` each item of ``iterator`` ``depth`` items ahead of the one
    yielded, so a batch's host work and copy overlap the step before it."""
    buf = collections.deque()
    for item in iterator:
        buf.append(place(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class _Staged(NamedTuple):
    tensors: Dict[str, torch.Tensor]  # on the card, written by the side stream
    copied: torch.cuda.Event          # recorded on the side stream after the copies


class _Placer:
    """Host batches (dicts of numpy arrays) onto the trainer's device for
    the streaming path. On the card each array is staged in pinned host
    memory and copied without blocking on a side stream, which records an
    event after the copies; :meth:`ready` makes the compute stream wait on
    that event and records the tensors' use on it, so the caching
    allocator gives their memory to no later copy before the step has
    read them (the pinned staging is the host allocator's, which holds it
    until its copy has run). On the CPU ``place`` is ``torch.as_tensor``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, arrays: Dict[str, np.ndarray]):
        if self.stream is None:
            return {k: torch.as_tensor(v) for k, v in arrays.items()}
        with torch.cuda.stream(self.stream):
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                       .to(self.device, non_blocking=True) for k, v in arrays.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return _Staged(tensors, copied)

    def ready(self, placed) -> Dict[str, torch.Tensor]:
        """The placed batch, safe to use on the current (compute) stream."""
        if self.stream is None:
            return placed
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(placed.copied)
        for t in placed.tensors.values():
            t.record_stream(compute)
        return placed.tensors


class Trainer:
    # Table elements above which "auto" takes the sparse table updates:
    # the JAX package's TPU v5e crossover, unmeasured on H100.
    SPARSE_AUTO_THRESHOLD = 32_000_000
    _TABLE_KEYS = ("user_table", "item_table", "item_bias")

    def __init__(self, config: RecsysConfig, output_dir: str = "outputs/run",
                 device: DeviceLike = "cuda", mesh_ctx: Optional[MeshContext] = None):
        """``mesh_ctx`` trains data-parallel over its ``data`` axis. Without
        one, a process whose launcher (``torchrun``) or caller started a
        process group of more than one rank makes the ``(data, 1)`` mesh
        over it; any other process trains on one device, with no group."""
        self.config = config
        self.output_dir = output_dir
        self._check_config()
        if mesh_ctx is None and world_size(device) > 1:
            mesh_ctx = make_mesh(model_parallel=1, data_parallel=config.mesh.data_axis,
                                 device=device)
        self.ctx = mesh_ctx
        if mesh_ctx is None:
            if config.mesh.data_axis not in (-1, 1):
                raise ValueError(f"mesh.data_axis={config.mesh.data_axis} needs a mesh of "
                                 "that many data ranks: start the ranks under torchrun")
            self.device = resolve_device(device)
        else:
            self._check_mesh(mesh_ctx)
            self.device = mesh_ctx.device
        self.optimizer = make_optimizer(config.train)
        self._schedule = opt_lib.make_schedule(config.train)
        self.writer = MetricWriter(output_dir)
        self.ckpt = ckpt_lib.CheckpointManager(
            f"{output_dir}/checkpoints", keep=config.train.keep_checkpoints,
            async_save=config.train.async_checkpoint)
        self._dropout_gen = torch.Generator(device=self.device)
        # steps taken on each path, so a caller can see which one ran
        self.step_counts = {"dense": 0, "sparse": 0}
        # the data path of the last train(): "resident" or "streaming"
        self.data_path: Optional[str] = None
        # negative_sampling="mined": a caller's [n_users, M] table (else
        # train() mines data.mined_from)
        self.mined_table: Optional[np.ndarray] = None
        # elements of the two embedding tables of the last state made
        # (what "auto" sparse updates reads), None before any
        self._table_elements: Optional[int] = None

    # ---- what this port runs ----------------------------------------
    def _check_config(self) -> None:
        cfg = self.config
        t, m = cfg.train, cfg.mesh
        if (m.model_axis != 1 or m.embedding_sharding != "replicated"
                or m.lookup_strategy != "xla"):
            _not_ported("a model-parallel mesh (model_axis > 1, embedding_sharding='rows', "
                        "lookup_strategy psum or a2a)", _ROW_SHARDED)
        if t.profile:
            _not_ported("TrainConfig.profile", _DEBUG_PROFILE)
        if t.debug_nans:
            _not_ported("TrainConfig.debug_nans", _DEBUG_PROFILE)

    def _check_mesh(self, ctx: MeshContext) -> None:
        """The port trains on a ``(data, 1)`` mesh, whose data axis
        ``mesh.data_axis`` matches (-1: any)."""
        if ctx.n_model != 1:
            _not_ported(f"a mesh with a model axis of {ctx.n_model}", _ROW_SHARDED)
        d = self.config.mesh.data_axis
        if d not in (-1, ctx.n_data):
            raise ValueError(f"mesh.data_axis={d} but the mesh has {ctx.n_data} data ranks")

    def _resolve_sparse_updates(self) -> bool:
        """``sparse_table_updates`` as set, or for "auto" whether the two
        embedding tables of the trainer's state hold more than
        ``SPARSE_AUTO_THRESHOLD`` elements."""
        stu = self.config.train.sparse_table_updates
        if stu != "auto":
            return bool(stu)
        if self._table_elements is None:
            raise ValueError('sparse_table_updates="auto" reads the table sizes: make '
                             "the state (init_state / state_from_params) before the step")
        return self._table_elements > self.SPARSE_AUTO_THRESHOLD

    def _check_cache_config(self, batch_rows: int) -> None:
        n = self.config.train.negative_cache
        if n <= 0:
            return
        if (self.ctx is not None and not self.config.train.global_negatives
                and self.ctx.n_data > 1):
            # per-replica negatives restrict each row's candidates to its
            # rank's batch; a replicated global cache would widen them back
            raise ValueError(
                "negative_cache composes with global_negatives only — per-replica "
                "negative scope contradicts a shared cross-batch cache")
        if n % batch_rows != 0:
            raise ValueError(
                f"negative_cache ({n}) must be a multiple of the global batch size "
                f"({batch_rows}) — the FIFO advances one batch per step")

    # ---- state -------------------------------------------------------
    def init_state(self, n_users: int, n_items: int, seed: int) -> TrainState:
        """Params from ``MultiTaskModel.init`` (drawn from a CPU generator
        seeded with ``seed``), on the trainer's device, with gradients on;
        fresh optimizer slots; an empty cache; step 0."""
        params = MultiTaskModel.init(torch.Generator().manual_seed(seed),
                                     self.config.model, n_users, n_items, self.device)
        return self.state_from_params(params, seed)

    def state_from_params(self, params, seed: int) -> TrainState:
        """A step-0 state around given params (moved to the trainer's
        device, gradients on), e.g. those of ``params_from_numpy``, with
        fresh slots and, under ``negative_cache``, an empty cache."""
        def own(node):
            if isinstance(node, dict):
                return {k: own(v) for k, v in node.items()}
            return node.detach().to(self.device, torch.float32).clone().requires_grad_(True)

        params = own(params)
        tw = params["towers"]
        self._table_elements = tw["user_table"].numel() + tw["item_table"].numel()
        extras = None
        n = self.config.train.negative_cache
        if n > 0:
            # empty slots: an id no item has (-1) and corr -1e9, so each
            # adds exp(-1e9) = 0 to the softmax: an exact no-op
            extras = {
                "emb": torch.zeros((n, self.config.model.embedding_dim), device=self.device),
                "ids": torch.full((n,), -1, dtype=torch.int32, device=self.device),
                "corr": torch.full((n,), -1e9, device=self.device),
            }
        return TrainState(params, self.optimizer.init(params), 0, seed + 1, extras)

    def _generator(self, state: TrainState) -> torch.Generator:
        """The step's dropout stream; under a mesh the data index is folded
        in (index 0 draws the one-card stream), so ranks draw independent
        masks."""
        seed = state.rng * 1_000_003 + state.step
        if self.ctx is not None:
            seed = (seed + self.ctx.data_index * _RANK_SEED_STRIDE) % (1 << 63)
        self._dropout_gen.manual_seed(seed)
        return self._dropout_gen

    # ---- data parallelism --------------------------------------------
    def _loss_axis(self) -> Dict[str, Any]:
        """``MultiTaskModel.loss``'s data-parallel arguments ({} on one card)."""
        ctx = self.ctx
        if ctx is None:
            return {}
        return dict(data_axis=ctx.data_axis, global_negatives=self.config.train.global_negatives,
                    data_axis_size=ctx.n_data, mesh_ctx=ctx)

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detached metrics, mean-reduced over ``data`` in one call under a mesh."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.ctx is None:
            return metrics
        keys = sorted(metrics)
        mean = collectives.allreduce_mean(self.ctx, torch.stack([metrics[k] for k in keys]))
        return dict(zip(keys, mean.unbind()))

    def _local_rows(self, tree, axis: int = 0):
        """This rank's slice of the global batch (numpy, axis ``axis``); the
        batch itself on one card."""
        return tree if self.ctx is None else local_slice(self.ctx, tree, axis)

    def _gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` in rank order (the global batch's rows)."""
        return x if self.ctx is None else collectives.gather_rows(self.ctx, x,
                                                                  self.ctx.data_axis)

    # ---- the step ----------------------------------------------------
    def _step_core(self, class_weights, use_explicit_negs: bool = False) -> Callable:
        """-> ``step_fn(state, batch) -> (state, metrics)``: the train step
        (loss, autograd, in-place optimizer update, the cache's FIFO),
        sparse or dense as ``_resolve_sparse_updates`` says when it is
        built; with ``use_explicit_negs`` the batch's ``neg_ids`` [B, K]
        feed the explicit softmax and the step is dense, as in the JAX
        package. ``batch`` holds tensors on the device; metrics stay there."""
        self._check_cache_config(self.config.train.batch_size)
        if not use_explicit_negs and self._resolve_sparse_updates():
            return self._step_core_sparse(class_weights)
        return self._step_core_dense(class_weights, use_explicit_negs)

    def _step_core_dense(self, class_weights, use_explicit_negs: bool = False) -> Callable:
        """The dense step: gradients of every leaf, the full-table update."""
        cfg = self.config
        opt = self.optimizer

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            batch = dict(batch)
            neg_ids = batch.pop("neg_ids") if use_explicit_negs else None
            paths, leaves = zip(*leaves_with_paths(state.params))
            _, metrics = MultiTaskModel.loss(
                state.params, cfg.model, batch, generator=self._generator(state),
                train=True, class_weights=class_weights, neg_item_ids=neg_ids,
                extra_candidates=self._cache_tuple(state), **self._loss_axis())
            grads = _grads(metrics["loss"], leaves)
            if self.ctx is not None:
                # the gradient of the global mean: the mean of the ranks'
                # (the gathered candidates' backward already summed the
                # other ranks' cotangents into this rank's item rows)
                grads = collectives.allreduce_mean_flat(self.ctx, grads)
            new_cache = self._cache_update(state, state.params, batch)  # pre-update params
            opt.update(_tree_from_paths(dict(zip(paths, grads))),
                       state.opt_state, state.params, state.step)
            self.step_counts["dense"] += 1
            return (state._replace(step=state.step + 1, extras=new_cache),
                    self._reduce_metrics(metrics))

        return step_fn

    def _step_core_sparse(self, class_weights) -> Callable:
        """The sparse step (``_step_core_sparse`` of the JAX package): the
        batch's table rows are gathered up front into virtual tables of
        exactly B rows, fresh leaves with gradients on, and the batch's ids
        become ``arange(B)`` with the true ids in ``mask_ids`` (the
        accidental-hit mask), so autograd returns per-occurrence [B, D] and
        [B] row gradients; :meth:`_sparse_apply` updates the touched rows.
        No [V, D] gradient is ever formed."""
        cfg = self.config
        if cfg.train.optimizer == "adam":
            logger.info(
                "sparse_table_updates with optimizer=adam uses LAZY-Adam "
                "semantics (untouched rows keep un-decayed moments; "
                "TF-LazyAdam parity), a deliberate divergence from dense "
                "Adam; set sparse_table_updates=False for exact dense-Adam "
                "math at full-table update cost.")
        # the dense leaves' optimizer; _sparse_apply clips before it, over
        # the dense gradients and the combined rows together
        dense_opt = make_optimizer(dataclasses.replace(cfg.train, clipnorm=0.0))

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            params = state.params
            tw = params["towers"]
            movie = batch["movie_id"].long()
            ids = {"user_table": batch["user_id"].long(), "item_table": movie,
                   "item_bias": movie}
            ids = {k: v.clamp(0, tw[k].shape[0] - 1) for k, v in ids.items()}
            virt = {k: tw[k].detach()[ids[k]].requires_grad_(True) for k in self._TABLE_KEYS}
            vparams = {**params, "towers": {**tw, **virt}}
            ar = torch.arange(movie.shape[0], dtype=torch.int32, device=movie.device)
            vbatch = {**batch, "user_id": ar, "movie_id": ar, "mask_ids": batch["movie_id"]}
            _, metrics = MultiTaskModel.loss(
                vparams, cfg.model, vbatch, generator=self._generator(state), train=True,
                class_weights=class_weights, extra_candidates=self._cache_tuple(state),
                **self._loss_axis())
            paths, leaves = zip(*leaves_with_paths(vparams))
            grads = dict(zip(paths, _grads(metrics["loss"], leaves)))
            if self.ctx is not None:
                grads, ids = self._global_sparse_grads(grads, ids)
            new_cache = self._cache_update(state, params, batch)  # pre-update params
            self._sparse_apply(state, grads, ids, dense_opt)
            self.step_counts["sparse"] += 1
            return (state._replace(step=state.step + 1, extras=new_cache),
                    self._reduce_metrics(metrics))

        return step_fn

    @torch.no_grad()
    def _global_sparse_grads(self, grads: Dict[Tuple[str, ...], torch.Tensor],
                             ids: Dict[str, torch.Tensor]):
        """The sparse step's gradients under a mesh -> (grads, ids) of the
        global batch, the same on every rank: the dense leaves averaged in
        one all-reduce; the virtual rows' per-occurrence gradients divided
        by the ranks (their item rows already hold the sum of every rank's
        cotangent, so this is the gradient of the global mean, the dense
        step's scale) and, with their true ids, all-gathered over ``data``
        in rank order (one gather for the rows, one for the ids)."""
        ctx = self.ctx
        table_paths = [("towers", k) for k in self._TABLE_KEYS]
        dense_paths = [p for p in grads if p not in table_paths]
        out = dict(zip(dense_paths, collectives.allreduce_mean_flat(
            ctx, [grads[p] for p in dense_paths])))
        gu, gi, gb = (grads[p] for p in table_paths)
        d_u = gu.shape[1]
        rows = self._gather_data(torch.cat([gu, gi, gb[:, None]], dim=1) / ctx.n_data)
        out[table_paths[0]] = rows[:, :d_u]
        out[table_paths[1]] = rows[:, d_u:-1]
        out[table_paths[2]] = rows[:, -1]
        all_ids = self._gather_data(torch.stack([ids[k] for k in self._TABLE_KEYS], dim=1))
        return out, dict(zip(self._TABLE_KEYS, all_ids.unbind(1)))

    @torch.no_grad()
    def _sparse_apply(self, state: TrainState, grads: Dict[Tuple[str, ...], torch.Tensor],
                      ids: Dict[str, torch.Tensor], dense_opt) -> None:
        """The update of the sparse step, in place (``_sparse_apply`` of
        the JAX package). ``grads`` maps each leaf's path to its gradient:
        per-occurrence rows (aligned with ``ids``) for the three table
        leaves, dense for the rest. Duplicates are combined; global-norm
        clipping runs over the dense gradients plus the combined rows (the
        dense step's norm: untouched rows add zero); ``dense_opt``, the
        configured optimizer without its own clipping, updates the dense
        leaves with the ranking LR scale; the tables take sparse adagrad or
        lazy Adam on their touched rows at the base LR."""
        t = self.config.train
        table_paths = {("towers", k): k for k in self._TABLE_KEYS}
        comb = {k: opt_lib.combine_duplicate_rows(ids[k], grads[p])
                for p, k in table_paths.items()}
        dense = {p: g for p, g in grads.items() if p not in table_paths}
        scale = None
        if t.clipnorm > 0:
            sq = sum(torch.sum(torch.square(g)) for g in dense.values())
            sq = sq + sum(torch.sum(torch.square(c[1])) for c in comb.values())
            scale = torch.clamp(t.clipnorm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
            dense = {p: g * scale for p, g in dense.items()}
        dense_opt.update(_tree_from_paths(dense), state.opt_state, state.params, state.step)
        lr = self._schedule(state.step)
        tw, slots = state.params["towers"], state.opt_state
        for k, (slot_ids, combined, valid) in comb.items():
            if t.optimizer == "adagrad":
                opt_lib.sparse_adagrad_combined(tw[k], slots["accum"]["towers"][k], slot_ids,
                                                combined, valid, lr, grad_scale=scale)
            else:  # adam -> lazy Adam on the touched rows
                opt_lib.sparse_lazy_adam_combined(
                    tw[k], slots["mu"]["towers"][k], slots["nu"]["towers"][k], slot_ids,
                    combined, valid, lr, state.step, grad_scale=scale)

    # ---- CBNS cross-batch negative cache (TrainConfig.negative_cache) --
    @staticmethod
    def _cache_tuple(state: TrainState):
        """extras -> the (emb, ids, corr) triple the loss takes."""
        if state.extras is None:
            return None
        c = state.extras
        return c["emb"], c["ids"], c["corr"]

    @torch.no_grad()
    def _cache_update(self, state: TrainState, params, batch):
        """The FIFO advanced by one batch: this batch's item embeddings
        (item tower in inference mode on the PRE-update params, the
        encodings this step scored) with their ``item_bias - log_q``
        correction appended, the oldest batch dropped. The ids are the true
        item ids. Under a mesh every rank appends the global batch."""
        if state.extras is None:
            return None
        cfg = self.config
        tw = params["towers"]
        ids = batch["movie_id"]
        emb = TwoTower.item_embed(tw, ids, cfg.model, train=False)
        corr = torch.zeros(ids.shape, dtype=torch.float32, device=emb.device)
        if cfg.model.use_item_bias:
            corr = corr + tw["item_bias"][ids.long().clamp(0, tw["item_bias"].shape[0] - 1)]
        if "log_q" in batch:
            corr = corr - batch["log_q"]
        if self.ctx is not None:  # the FIFO gains the global batch, in rank order
            rows = self._gather_data(torch.cat([emb.float(), corr[:, None]], dim=1))
            emb, corr, ids = rows[:, :-1], rows[:, -1], self._gather_data(ids)
        b = ids.shape[0]
        c = state.extras
        return {"emb": torch.cat([c["emb"][b:], emb.float()]),
                "ids": torch.cat([c["ids"][b:], ids.to(c["ids"].dtype)]),
                "corr": torch.cat([c["corr"][b:], corr])}

    def make_train_step(self, class_weights, use_explicit_negs: bool = False) -> Callable:
        return self._step_core(class_weights, use_explicit_negs)

    def make_train_chunk(self, class_weights, use_explicit_negs: bool,
                         n_steps: int) -> Callable:
        """-> ``chunk_fn(state, chunk) -> (state, mean metrics)``: the train
        step over the ``n_steps`` slices of a ``[n_steps, B, ...]`` stack
        (one transfer for the chunk; ``stream_chunk_steps``), in order, the
        same math as ``n_steps`` single steps."""
        step_fn = self._step_core(class_weights, use_explicit_negs)

        def chunk_fn(state: TrainState, chunk: Dict[str, torch.Tensor]):
            sums = {}
            for i in range(n_steps):
                state, metrics = step_fn(state, {k: v[i] for k, v in chunk.items()})
                sums = {k: sums.get(k, 0.0) + v for k, v in metrics.items()}
            return state, {k: v / n_steps for k, v in sums.items()}

        return chunk_fn

    def make_eval_step(self, class_weights) -> Callable:
        """-> ``eval_fn(params, batch) -> metrics``: the loss metrics of one
        (masked) batch in inference mode."""
        cfg = self.config

        @torch.no_grad()
        def eval_fn(params, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            _, metrics = MultiTaskModel.loss(params, cfg.model, batch, train=False,
                                             class_weights=class_weights)
            return metrics

        return eval_fn

    def make_train_epoch(self, class_weights, n_rows: int, n_steps: int,
                         use_explicit_negs: bool = False) -> Callable:
        """-> ``epoch_fn(state, data, epoch) -> (state, mean metrics)`` over
        device-resident ``data``: a permutation of the rows on the device
        from a generator seeded by (seed ^ 0x5EED, epoch), then ``n_steps``
        steps of ``batch_size`` rows (the remainder is dropped); every
        column is gathered, ``neg_ids`` [N, K] too. Under a mesh every rank
        holds the whole split and draws the same permutation, and takes its
        slice of each global batch."""
        b = self.config.train.batch_size
        step_fn = self._step_core(class_weights, use_explicit_negs)
        perm_gen = torch.Generator(device=self.device)
        base = self.config.train.seed ^ 0x5EED
        lo, bl = 0, b
        if self.ctx is not None:
            bl = self.ctx.local_batch(b)
            lo = self.ctx.data_index * bl

        def epoch_fn(state: TrainState, data: Dict[str, torch.Tensor], epoch: int):
            perm_gen.manual_seed(base * 1_000_003 + epoch)
            perm = torch.randperm(n_rows, generator=perm_gen, device=self.device)
            sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
            for i in range(n_steps):
                idx = perm[i * b + lo:i * b + lo + bl]
                state, metrics = step_fn(state, {k: v[idx] for k, v in data.items()})
                for k in METRIC_KEYS:
                    sums[k] += metrics[k]
            return state, {k: v / max(n_steps, 1) for k, v in sums.items()}

        return epoch_fn

    def make_val_epoch(self, class_weights, n_steps: int) -> Callable:
        """-> ``val_fn(params, data) -> metrics``: the mask-weighted mean of
        the loss metrics over ``n_steps`` padded batches."""
        cfg = self.config
        b = cfg.train.batch_size

        @torch.no_grad()
        def val_fn(params, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
            wsum = torch.zeros((), device=self.device)
            for i in range(n_steps):
                batch = {k: v[i * b:(i + 1) * b] for k, v in data.items()}
                _, metrics = MultiTaskModel.loss(params, cfg.model, batch, train=False,
                                                 class_weights=class_weights)
                w = torch.sum(batch["mask"])
                for k in METRIC_KEYS:
                    sums[k] += metrics[k] * w
                wsum += w
            return {k: v / torch.clamp(wsum, min=1.0) for k, v in sums.items()}

        return val_fn

    # ---- checkpoints -------------------------------------------------
    @staticmethod
    def _state_dict(state: TrainState) -> Dict[str, Any]:
        """The checkpointed tree; ``extras`` (the cache) is None and left
        out of the npz when the cache is off, as in the JAX package."""
        return {"params": state.params, "opt_state": state.opt_state,
                "step": np.int64(state.step), "rng": np.int64(state.rng),
                "extras": state.extras}

    @staticmethod
    def _copy_into(live, saved) -> None:
        """Copy a saved (numpy) tree into the live tensors of the same tree."""
        saved = dict(leaves_with_paths(saved))
        with torch.no_grad():
            for path, t in leaves_with_paths(live):
                t.copy_(torch.from_numpy(np.asarray(saved[path])))

    def _load_state(self, state: TrainState, tree: Dict) -> TrainState:
        self._copy_into(state.params, tree["params"])
        self._copy_into(state.opt_state, tree["opt_state"])
        if state.extras is not None and "extras" in tree:
            self._copy_into(state.extras, tree["extras"])  # a warm cache
        return state._replace(step=int(tree["step"]), rng=int(tree["rng"]))

    def _make_sampler(self, bundle: Dict[str, np.ndarray],
                      n_items: int) -> Optional[NegativeSampler]:
        """The explicit-negatives sampler of ``data.negative_sampling``
        (None for "random": in-batch negatives only), fitted on the train
        split with ``train.seed``; "mined" installs ``self.mined_table`` or
        mines ``data.mined_from`` on the trainer's device."""
        cfg = self.config
        d = cfg.data
        if d.negative_sampling not in ("hard", "mixed", "mined"):
            return None
        sampler = NegativeSampler(d.negative_sampling, d.num_hard_negatives,
                                  d.num_random_negatives, seed=cfg.train.seed).fit(
            bundle["train/user_id"], bundle["train/movie_id"], n_items)
        if d.negative_sampling != "mined":
            return sampler
        if cfg.model.explicit_negatives_weight > 0.25:
            logger.warning(
                "negative_sampling='mined' with explicit_negatives_weight=%.2f: the "
                "weight scales the explicit softmax that pushes each user's mined items "
                "down, and mined items include the user's future positives (ranks past "
                "mined_skip_top=%d too); a weight near 1 can cost recall, 0.1 keeps the "
                "in-batch loss in charge", cfg.model.explicit_negatives_weight,
                d.mined_skip_top)
        table = self.mined_table
        if table is None and d.mined_from:
            from recsys_tpu_torch.train.checkpoint import load_encoder_params

            logger.info("mining hard negatives from %s", d.mined_from)
            table = mine_hard_negatives(load_encoder_params(d.mined_from), cfg.model, bundle,
                                        m=d.mined_pool_size, skip_top=d.mined_skip_top,
                                        device=self.device)
        if table is None:
            raise ValueError("negative_sampling='mined' needs a mined table: set "
                             "trainer.mined_table or data.mined_from (a trained serving "
                             "bundle dir)")
        return sampler.set_mined(table)

    def _stream_epoch(self, state: TrainState, epoch: int, batches, augment, placer: _Placer,
                      train_step: Callable, train_chunk: Optional[Callable],
                      chunk_k: int) -> Tuple[TrainState, int, Dict[str, float]]:
        """One streaming epoch: ``batches`` (the Batcher's global batches) in
        groups of ``chunk_k``, each ``augment``-ed on the host, cut to this
        rank's slice under a mesh, and placed two groups ahead; a full
        group through ``train_chunk`` in one transfer, the
        tail step by step. Train metrics are read where ``log_every_steps``
        is crossed and at the first step; a checkpoint is saved where
        ``checkpoint_every_steps`` is crossed. -> (state, steps, the mean of
        the metrics read)."""
        t_cfg = self.config.train
        agg: Dict[str, float] = {}
        n_read = n_steps = 0

        def grouped(it):
            buf = []
            for b in it:
                buf.append(b)
                if len(buf) == chunk_k:
                    yield buf
                    buf = []
            if buf:
                yield buf

        def prepare(group):
            # the global batches (their negatives too), then this rank's slice
            group = [augment(b) for b in group]
            if len(group) == chunk_k and train_chunk is not None:
                return len(group), placer(self._local_rows(
                    {k: np.stack([b[k] for b in group]) for k in group[0]}, axis=1))
            return 0, [placer(self._local_rows(b)) for b in group]

        def log_or_ckpt(state, metrics, prev):
            nonlocal n_read

            def crossed(every):
                return every and n_steps // every > prev // every

            if crossed(t_cfg.log_every_steps) or prev == 0:
                for k, v in metrics.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
                n_read += 1
            if crossed(t_cfg.checkpoint_every_steps):
                self.ckpt.save(state.step, self._state_dict(state),
                               metrics={"mid_epoch": float(epoch)})

        for csize, placed in _prefetch(grouped(batches), prepare):
            if csize:
                prev = n_steps
                state, metrics = train_chunk(state, placer.ready(placed))
                n_steps += csize
                log_or_ckpt(state, metrics, prev)
            else:
                for b in placed:
                    prev = n_steps
                    state, metrics = train_step(state, placer.ready(b))
                    n_steps += 1
                    log_or_ckpt(state, metrics, prev)
        return state, n_steps, {f"train_{k}": v / max(n_read, 1) for k, v in agg.items()}

    # ---- the training loop -------------------------------------------
    def train(self, bundle: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg = self.config
        t_cfg = cfg.train
        dev = self.device
        n_users = int(bundle["meta/n_users"])
        n_items = int(bundle["meta/n_movies"])
        logger.info("training: %d users, %d items on %s%s", n_users, n_items, dev,
                    "" if self.ctx is None else f", data-parallel over {self.ctx.n_data} ranks")
        self.writer.write_config(cfg)

        class_weights = (losses.balanced_class_weights(bundle["train/y_implicit"])
                         if t_cfg.use_class_weights else (1.0, 1.0))
        log_q_table = None
        if t_cfg.logq_correction:
            pop = np.bincount(bundle["train/movie_id"], minlength=n_items).astype(np.float32)
            log_q_table = np.log(np.maximum(pop, 0.5)
                                 / max(len(bundle["train/movie_id"]), 1)).astype(np.float32)

        # engineered dense features: fitted on train on the host, one
        # standardized [N, F] matrix per split, a batch column like the
        # others; the fitted engineer ships in the inference bundle
        dense_feats = None
        engineer = None
        if cfg.model.dense_features > 0:
            engineer = make_engineer(bundle, cfg.model.dense_features)
            dense_feats = engineer.fit_transform_splits(bundle)
        sampler = self._make_sampler(bundle, n_items)
        use_negs = sampler is not None

        batch_cols = BATCH_COLUMNS
        data = bundle
        if dense_feats is not None:
            data = {**bundle, **{f"{s}/dense": v for s, v in dense_feats.items()}}
            batch_cols = batch_cols + ("dense",)
        # every rank reads the global batches (the one-card run's) and the
        # negatives drawn for them, then cuts its slice: the sampler's stream
        # stays the one-card stream, which per-process Batcher slices would
        # not give (each process would draw for its slice only)
        train_batcher = Batcher(data, "train", t_cfg.batch_size, seed=t_cfg.seed,
                                columns=batch_cols)
        val_batcher = Batcher(data, "val", t_cfg.batch_size, seed=t_cfg.seed, shuffle=False,
                              drop_remainder=False, columns=batch_cols)
        train_cols = {c: data[f"train/{c}"] for c in batch_cols}
        if log_q_table is not None:
            train_cols["log_q"] = log_q_table[train_cols["movie_id"]]
        n_rows = len(train_cols["user_id"])
        steps_per_epoch = train_batcher.steps_per_epoch

        state = self.init_state(n_users, n_items, t_cfg.seed)
        if log_q_table is not None:
            # item_bias starts at the log train frequency, so the
            # logQ-corrected softmax starts balanced
            bias = state.params["towers"]["item_bias"]
            bias0 = np.full(bias.shape[0], float(log_q_table.min()), np.float32)
            bias0[:n_items] = log_q_table
            with torch.no_grad():
                bias.copy_(torch.from_numpy(bias0))
        start_epoch = 0
        if t_cfg.resume:
            restored = self.ckpt.restore_latest()
            if restored is not None:
                state = self._load_state(state, restored[1])
                start_epoch = state.step // max(steps_per_epoch, 1)
                logger.info("resumed from checkpoint step %d (epoch %d)",
                            restored[0], start_epoch)

        # the data path: the split (and its [N, K] negatives) on the device
        # within device_data_limit_mb, else streamed from the host
        data_bytes = sum(v.nbytes for v in train_cols.values())
        neg_bytes = 4 * sampler.n_negatives() * n_rows if use_negs else 0
        resident = (t_cfg.device_resident_data
                    and data_bytes + neg_bytes <= t_cfg.device_data_limit_mb * 1024 * 1024)
        self.data_path = "resident" if resident else "streaming"

        def on_device(arr):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(dev)

        def augment(batch):
            if log_q_table is not None:
                batch = {**batch, "log_q": log_q_table[batch["movie_id"]]}
            return batch

        def augment_negs(batch):
            batch = augment(batch)
            if use_negs:
                batch = {**batch, "neg_ids": sampler.sample_batch(batch["user_id"])}
            return batch

        val_dense = None if dense_feats is None else dense_feats["val"]
        if resident:
            train_data = {k: on_device(v) for k, v in train_cols.items()}
            n_val = len(bundle["val/user_id"])
            val_steps = max(-(-n_val // t_cfg.batch_size), 1)
            pad = val_steps * t_cfg.batch_size - n_val
            val_data = {c: on_device(np.pad(bundle[f"val/{c}"], (0, pad)))
                        for c in BATCH_COLUMNS}
            if log_q_table is not None:
                val_data["log_q"] = on_device(
                    log_q_table[np.pad(bundle["val/movie_id"], (0, pad))])
            val_data["mask"] = on_device(np.pad(np.ones(n_val, np.float32), (0, pad)))
            if val_dense is not None:
                val_data["dense"] = on_device(np.pad(val_dense, ((0, pad), (0, 0))))
            train_epoch = self.make_train_epoch(class_weights, n_rows, steps_per_epoch,
                                                use_explicit_negs=use_negs)
            val_epoch = self.make_val_epoch(class_weights, val_steps)
            logger.info("device-resident data: %d train rows (%.1f MB), %d steps/epoch",
                        n_rows, (data_bytes + neg_bytes) / 1e6, steps_per_epoch)
        else:
            placer = _Placer(dev)
            if use_negs:
                # the JAX trainer draws one example batch's negatives here
                # (the batch it compiles against): the same draw keeps the
                # sampler's stream, and so every negative, equal to the JAX
                # package's
                train_example = next(iter(train_batcher.epoch(0)))
                sampler.sample_batch(train_example["user_id"])
            train_step = self.make_train_step(class_weights, use_negs)
            eval_step = self.make_eval_step(class_weights)
            chunk_k = min(max(int(t_cfg.stream_chunk_steps), 1), max(steps_per_epoch, 1))
            if t_cfg.checkpoint_every_steps:
                # a chunk never steps over a mid-epoch checkpoint
                chunk_k = min(chunk_k, int(t_cfg.checkpoint_every_steps))
            train_chunk = (self.make_train_chunk(class_weights, use_negs, chunk_k)
                           if chunk_k > 1 else None)
            logger.info("streaming data: %d train rows (%.1f MB with negatives), %d "
                        "steps/epoch, %d steps a transfer", n_rows,
                        (data_bytes + neg_bytes) / 1e6, steps_per_epoch, chunk_k)

        best_val = float("inf")
        best_params_host = None
        patience = 0
        examples_total = 0
        t_train0 = time.time()
        final_epoch = start_epoch
        preempted = False
        self._preempt_requested = False
        prev_handlers = {}
        if (t_cfg.checkpoint_on_preemption
                and threading.current_thread() is threading.main_thread()):
            def on_signal(signum, frame):
                logger.warning("signal %d received: checkpointing at epoch end, then "
                               "stopping (resume with --set train.resume=true)", signum)
                self._preempt_requested = True

            for sig in (signal.SIGTERM, signal.SIGUSR1):
                prev_handlers[sig] = signal.signal(sig, on_signal)

        try:
            for epoch in range(start_epoch, t_cfg.epochs):
                final_epoch = epoch
                self.writer.start_epoch()
                t0 = time.time()
                if resident:
                    if use_negs:
                        # fresh explicit negatives each epoch, one [N, K] column
                        train_data["neg_ids"] = on_device(
                            sampler.sample_batch(train_cols["user_id"]))
                    state, tmetrics = train_epoch(state, train_data, epoch)
                    n_steps = steps_per_epoch
                    logs = {f"train_{k}": float(v) for k, v in tmetrics.items()}  # syncs
                else:
                    state, n_steps, logs = self._stream_epoch(
                        state, epoch, train_batcher.epoch(epoch), augment_negs, placer,
                        train_step, train_chunk, chunk_k)
                    if dev.type == "cuda":  # the epoch's time ends with its last step
                        torch.cuda.synchronize(dev)
                epoch_time = time.time() - t0
                examples_total += n_steps * t_cfg.batch_size
                logs["examples_per_s"] = n_steps * t_cfg.batch_size / max(epoch_time, 1e-9)
                if resident:
                    logs.update({f"val_{k}": float(v)
                                 for k, v in val_epoch(state.params, val_data).items()})
                else:
                    # the unweighted mean of the val batches' masked means
                    v_agg: Dict[str, float] = {}
                    v_steps = 0
                    for batch in val_batcher.epoch(0):
                        metrics = eval_step(state.params, placer.ready(placer(augment(batch))))
                        for k, v in metrics.items():
                            v_agg[k] = v_agg.get(k, 0.0) + float(v)
                        v_steps += 1
                    logs.update({f"val_{k}": v / max(v_steps, 1) for k, v in v_agg.items()})
                if t_cfg.eval_every_epochs and (epoch + 1) % t_cfg.eval_every_epochs == 0:
                    sample_cfg = dataclasses.replace(
                        cfg.eval, eval_sample=cfg.eval.eval_sample or 20_000, topk=(10,))
                    logs["val_recall@10"] = evaluate(
                        state.params, cfg.model, bundle, "val", sample_cfg, seed=t_cfg.seed,
                        dense=val_dense)["recall@10"]
                if (self.ctx is not None and t_cfg.replication_check_every_epochs
                        and (epoch + 1) % t_cfg.replication_check_every_epochs == 0
                        and self.ctx.n_data > 1):
                    logs["replica_checksum"] = float(assert_replicated(state.params,
                                                                       self.ctx)[0])
                self.writer.end_epoch(epoch, logs)
                if self._preempted_anywhere():
                    self.ckpt.save(state.step, self._state_dict(state),
                                   metrics={"val_loss": logs.get("val_loss", float("nan"))})
                    preempted = True
                    logger.info("preemption checkpoint saved (epoch %d, step %d)",
                                epoch, state.step)
                    break
                monitor = t_cfg.early_stop_metric
                sign = -1.0 if "recall" in monitor or "auc" in monitor else 1.0
                value = logs.get(monitor)
                if value is None and monitor != "val_loss":
                    # not computed this epoch (eval_every_epochs cadence)
                    self.ckpt.save(state.step, self._state_dict(state),
                                   metrics={"val_loss": logs.get("val_loss", float("nan"))})
                    continue
                if value is None:
                    value = logs.get("val_loss", float("inf"))
                score = sign * value  # lower is better
                is_best = score < best_val
                if is_best:
                    best_val = score
                    best_params_host = ckpt_lib.params_to_numpy(state.params)
                    patience = 0
                else:
                    patience += 1
                self.ckpt.save(state.step, self._state_dict(state),
                               metrics={monitor: value}, is_best=is_best)
                if patience >= t_cfg.early_stop_patience:
                    logger.info("early stopping at epoch %d (best %s %.4f)", epoch,
                                monitor, sign * best_val)
                    break
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.ckpt.wait()

        if not preempted and best_params_host is not None:
            self._copy_into(state.params, best_params_host)
        wall = time.time() - t_train0
        self.final_state = state
        # rank 0 (the only rank without a mesh) evaluates and writes; the
        # others take its report and wait for its files at the barrier
        writer = self.ctx is None or dist.get_rank() == 0
        report = None
        if writer and preempted:
            report = {"preempted": True, "train_wall_time_s": wall,
                      "epochs_run": final_epoch + 1, "resume_step": state.step}
        elif writer:
            report = evaluate(state.params, cfg.model, bundle, "val", cfg.eval,
                              seed=t_cfg.seed, dense=val_dense)
            report["train_wall_time_s"] = wall
            report["examples_per_s"] = examples_total / max(wall, 1e-9)
            report["epochs_run"] = final_epoch + 1
        if writer:
            self.writer.write_final_metrics(report)
            self.writer.close()
        if writer and not preempted:
            index = RetrievalIndex.build(state.params["towers"], cfg.model, n_items,
                                         bundle["meta/movie_raw_ids"], device=dev)
            ckpt_lib.save_inference_bundle(
                f"{self.output_dir}/serving", state.params["towers"], cfg,
                bundle["meta/user_raw_ids"], bundle["meta/movie_raw_ids"],
                index=index, full_params=state.params,
                feature_state=None if engineer is None else engineer.state_dict())
        if self.ctx is not None:
            shared = [report]
            dist.broadcast_object_list(shared, src=0)
            dist.barrier()
            report = shared[0]
        return report

    def _preempted_anywhere(self) -> bool:
        """Whether SIGTERM or SIGUSR1 reached this process, or under a mesh
        any rank (max-reduced, so every rank saves and stops at one step)."""
        flag = self._preempt_requested
        if self.ctx is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)
