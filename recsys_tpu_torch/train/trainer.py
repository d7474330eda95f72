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

**Row-sharded tables** (``MeshConfig.embedding_sharding="rows"`` on a
``(data, model)`` mesh with ``model`` above 1; the JAX package's
``_step_core_spmd`` with its psum and a2a lookups): ``user_table`` and
``item_table`` (padded to ``rows_multiple = n_model``) and their
optimizer slots are split by rows over ``model``; ``item_bias`` and every
other leaf stay whole on every rank. The batch is split over ``data``
only, so the ranks that share a data index run the same loss on the same
slice, reading the tables through ``embed/table.py``'s lookup of
``lookup_strategy``: psum (its backward the identity), or a2a, whose
capacity is sized from each call's id count (the explicit negatives'
``[B_local * K]`` too) and whose rows' cotangent is divided by
``n_model`` on the way back (the transpose of JAX's ``pmean``), with
``lookup_overflow`` among the metrics and a warning naming
``lookup_capacity_factor`` when an epoch's mean is above 0. "xla" reads
the tables through the psum body: the JAX package runs a GSPMD gather
there, which the port has not, and its own explicit step does the same
when another reason forces it; all three give one result. Every gradient,
the shards' too, is averaged over ``data`` in the one flat all-reduce;
the optimizer's global-norm clip adds the shards' squared sums over
``model``. The sparse step gathers its virtual rows through the lookup;
every rank combines the global batch's rows and each writes only the ids
it owns, at their local rows. Validation and the loss metrics read the
tables through the psum lookup on every rank (exact, as JAX's GSPMD
gather). A checkpoint keeps the one-card npz layout, but no host holds a
whole table for it (the JAX package's orbax path): the ranks of data index
0 send their shards and slots in chunks to rank 0, which streams them into
the file, and on restore each rank reads only its own rows of them. The
periodic and the final ``evaluate``, ``RetrievalIndex.build`` and the
inference bundle (the padded tables, as the JAX package writes them) take
the whole tables on rank 0's host, where those ranks send their shards in
chunks (``parallel.sharding.gather_table``, the JAX package's
``device_get``); no other rank holds a whole table, and rank 0 broadcasts
what it evaluated. ``replication_check_every_epochs`` checks the whole leaves
over every rank and skips the shards. At ``n_model == 1`` the tables
stay whole, as in the JAX package.

**Debugging** (``TrainConfig.debug_nans``, ``TrainConfig.profile``):
``debug_nans`` turns on the process-wide NaN checks of ``utils/debug.py``
(the port's ``jax_debug_nans``): every step checks its loss and gradients
before the update and its params after it (:class:`_NanGuard`: one
reduction, one host sync a step; no result changes), and on a NaN re-runs
its forward and backward to name the op or kernel that made it, raising
``FloatingPointError``; the validation metrics are checked alike.
``profile`` traces the first epoch's train steps on rank 0 with
``torch.profiler`` into ``<output_dir>/profile`` (a TensorBoard trace
directory), where the JAX package starts and stops its trace. There each
step's kernels sit under the spans of ``utils/trace.py``: ``train.step``
around ``train.forward`` (with ``loss.retrieval``), ``train.backward``
(with ``loss.retrieval_bwd``, the flash route's backward, on the autograd
thread), ``train.update`` and ``train.cache_update``, and
``train.exchange`` around the collectives under a mesh. A span records
nothing without a running profiler.

**DLRM-DCNv2** (``ModelConfig.arch="dlrm_dcnv2"``, ``models/dlrm.py``; no
counterpart in the JAX package): on one device, with Adagrad and no
clipping. The state holds the dense leaves (with Adagrad's slots) and one
concatenated fp32 table of every categorical table (drawn on the device
from the seed by ``init_state``), with one row-wise Adagrad accumulator a
row. A step (:meth:`_step_core_dlrm`, taken by ``make_train_epoch``,
``make_train_step`` and ``make_train_chunk`` alike) pools the batch's
multi-hot bags from the table, runs the dense forward and autograd over
the dense leaves and the bags, then updates the dense leaves and, fused
with the bags' backward, only the looked-up rows of the table
(``ops/embedding_bag.py``: one sort of the lookups, no [B x lookups, D]
tensor, no host sync); its metrics count the lookups and the rows updated
on the device. ``train`` takes a bundle of ``dense``, ``sparse`` and
``label`` columns (:meth:`_train_dlrm`).

Dropout masks come from a ``torch.Generator`` on the device, reseeded from
(seed + 1, step) every step, and from the rank's data index under a mesh
(index 0 draws the one-card stream), so a run and its resume, and a step's
re-run under ``debug_nans``, draw the same masks; they are not JAX's masks.
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
from recsys_tpu_torch.embed.table import (a2a_capacity, a2a_overflow, lookup_a2a,
                                          make_sharded_lookup_psum)
from recsys_tpu_torch.models import dlrm, losses
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops import embedding_bag as eb
from recsys_tpu_torch.parallel import collectives
from recsys_tpu_torch.parallel.mesh import MeshContext, make_mesh, world_size
from recsys_tpu_torch.parallel.sharding import local_slice, shard_rows
from recsys_tpu_torch.retrieval.evaluator import evaluate
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train import checkpoint as ckpt_lib
from recsys_tpu_torch.train import optimizer as opt_lib
from recsys_tpu_torch.train.optimizer import leaves_with_paths, make_optimizer
from recsys_tpu_torch.utils.debug import (assert_replicated, deferred_nan_checks,
                                          enable_nan_checks, locate_nan, nan_checks_enabled,
                                          nan_message)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device
from recsys_tpu_torch.utils.metrics_io import MetricWriter
from recsys_tpu_torch.utils.trace import span

logger = logging.getLogger(__name__)

METRIC_KEYS = ("loss", "retrieval_loss", "rating_mse", "ctr_bce", "l2")
BATCH_COLUMNS = ("user_id", "movie_id", "rating", "y_implicit")
# dlrm_dcnv2: the step's metrics (the BCE, and the lookups and rows
# updated a step, counted on the device) and a bundle's columns
DLRM_METRIC_KEYS = ("loss", "lookups", "unique_rows")
DLRM_COLUMNS = ("dense", "sparse", "label")


class TrainState(NamedTuple):
    params: Any      # nested dict of fp32 leaves with requires_grad
    opt_state: Any   # the optimizer's slots, same tree per slot name
    step: int        # a host count
    rng: int         # the dropout seed; masks of a step derive from (rng, step)
    # the CBNS cache {"emb" [N, D], "ids" [N], "corr" [N]} (a FIFO, newest
    # batch last) when TrainConfig.negative_cache > 0, else None
    extras: Any = None


# the leaves split by rows over ``model`` under row-sharded tables
_SHARDED_KEYS = ckpt_lib.ROW_SHARDED_KEYS
# a large odd constant: data index r adds r times it to the dropout seed
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


def _tree_from_paths(values: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, v in values.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _grads(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaves; a leaf the loss does not reach (item_bias under
    use_item_bias=False) gets a zero gradient, as in JAX."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def _nan_flags(tensors) -> torch.Tensor:
    """[len(tensors)] bool on their device: which of them hold a NaN, in
    one fused reduction (a NaN, and nothing else, makes an L2 norm NaN)."""
    return torch.isnan(torch.stack(torch._foreach_norm([t.detach() for t in tensors])))


class _NanGuard:
    """``debug_nans`` over the train loop. :meth:`check` takes a step's
    loss and gradients (after the data all-reduce) before the update, and
    the params flags of the update before it (:meth:`updated`, read here
    or by :meth:`flush` before a checkpoint and at an epoch's end): one
    reduction and one host sync a step, so a NaN from the forward or
    backward leaves the state untouched, as JAX's failed jitted step does.
    Under a mesh one scalar all-reduce (max of ``kind * world + rank``)
    tells every rank the worst kind any rank saw (2: params after an
    update, 1: the loss or a gradient) and where, so every rank raises at
    the same step and none waits in a collective. On a kind 1 the step's
    forward and backward re-run under ``locate_nan`` on every rank,
    collectives and all, to name the op; if it meets none, the leaf is
    named."""

    UPDATE, STEP = 2, 1

    def __init__(self, ctx: Optional[MeshContext], optimizer: str):
        self.ctx = ctx
        self.optimizer = optimizer
        self._pending = None  # (step, paths, flags) of the last update's params

    def _worst(self, kind: torch.Tensor) -> Tuple[int, int]:
        """(kind, rank) of the worst NaN over every rank, kind 0 for none."""
        if self.ctx is None:
            return int(kind), 0
        world = dist.get_world_size()
        kind = kind.to(self.ctx.device)
        code = torch.where(kind > 0, kind * world + dist.get_rank(), -1).to(torch.float32)
        dist.all_reduce(code.reshape(1), op=dist.ReduceOp.MAX)
        code = int(code)
        return (0, 0) if code < 0 else divmod(code, world)

    def _raise(self, what: Optional[str], rank: int, step: int):
        if what is None:  # the NaN is on another rank
            what = f"rank {rank}'s step"
        raise FloatingPointError(f"{nan_message(what)} at step {step}")

    def _update_name(self) -> Optional[str]:
        step, paths, flags = self._pending
        hit = [p for p, f in zip(paths, flags.tolist()) if f]
        return (f"params {'/'.join(hit[0])} after the {self.optimizer} update of step {step}"
                if hit else None)

    def updated(self, step: int, params) -> None:
        paths, leaves = zip(*leaves_with_paths(params))
        self._pending = (step, paths, _nan_flags(leaves))

    def flush(self) -> None:
        if self._pending is None:
            return
        kind, rank = self._worst(self.UPDATE * self._pending[2].any().to(torch.int64))
        if kind:
            self._raise(self._update_name(), rank, self._pending[0])
        self._pending = None

    def check(self, step: int, loss: torch.Tensor, grads: Dict[Tuple[str, ...], torch.Tensor],
              rerun: Callable[[], Any]) -> None:
        flags = _nan_flags([loss, *grads.values()])
        kind = self.STEP * flags.any().to(torch.int64)
        if self._pending is not None:
            kind = torch.maximum(kind, self.UPDATE * self._pending[2].any().to(torch.int64))
        kind, rank = self._worst(kind)
        if kind == self.UPDATE:
            self._raise(self._update_name(), rank, self._pending[0])
        self._pending = None
        if kind == self.STEP:
            names = ["the loss"] + [f"the gradient of {'/'.join(p)}" for p in grads]
            hit = [n for n, f in zip(names, flags.tolist()) if f]
            self._locate(rerun, hit[0] if hit else None, rank, step)

    def check_values(self, what: str, values: Dict[str, float], rerun: Callable[[], Any],
                     step: int) -> None:
        """Host metrics (the validation pass's): a NaN among them is
        located by re-running ``rerun``."""
        hit = [k for k, v in values.items() if v != v]
        kind, rank = self._worst(torch.tensor(self.STEP * bool(hit)))
        if kind:
            self._locate(rerun, f"{what} ({hit[0]})" if hit else None, rank, step)

    def _locate(self, rerun, leaf: Optional[str], rank: int, step: int):
        try:
            named = locate_nan(rerun, collective=self.ctx is not None)
        except FloatingPointError as e:
            raise FloatingPointError(f"{e} at step {step}") from e
        self._raise(named or leaf, rank, step)


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
        """``mesh_ctx`` trains over its ``(data, model)`` axes. Without one,
        a process whose launcher (``torchrun``) or caller started a process
        group of more than one rank makes the mesh of ``config.mesh`` over
        it; any other process trains on one device, with no group."""
        self.config = config
        self.output_dir = output_dir
        if mesh_ctx is None and world_size(device) > 1:
            mesh_ctx = make_mesh(model_parallel=config.mesh.model_axis,
                                 data_parallel=config.mesh.data_axis, device=device)
        self.ctx = mesh_ctx
        if mesh_ctx is None:
            for axis in ("data_axis", "model_axis"):
                if getattr(config.mesh, axis) not in (-1, 1):
                    raise ValueError(f"mesh.{axis}={getattr(config.mesh, axis)} needs a mesh "
                                     "of that many ranks: start the ranks under torchrun")
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
        # (what "auto" sparse updates reads; the whole tables' under
        # row sharding), None before any
        self._table_elements: Optional[int] = None
        # row-sharded tables: the JAX package's rule (rows and model > 1)
        self.rows = (mesh_ctx is not None and config.mesh.embedding_sharding == "rows"
                     and mesh_ctx.n_model > 1)
        self._nan_guard = _NanGuard(mesh_ctx, config.train.optimizer)
        self.dlrm = config.model.arch == "dlrm_dcnv2"
        if self.dlrm:
            self._check_dlrm()

    def _check_dlrm(self) -> None:
        """The modes DLRM-DCNv2 trains in: one device, Adagrad (row-wise on
        the tables), no clipping (the source clips nothing, and the fused
        table update has no global norm to clip by), no cache."""
        t = self.config.train
        for bad, what in ((self.ctx is not None, "a mesh"),
                          (t.optimizer != "adagrad", f"optimizer={t.optimizer!r}"),
                          (t.clipnorm > 0, f"clipnorm={t.clipnorm}"),
                          (t.negative_cache > 0, "negative_cache")):
            if bad:
                raise ValueError(f"arch dlrm_dcnv2 trains on one device with adagrad, "
                                 f"clipnorm 0 and no cache, not with {what}")
        self._layout = eb.make_layout(self.config.model.table_rows,
                                      self.config.model.bag_sizes, self.device)

    def _check_mesh(self, ctx: MeshContext) -> None:
        """The mesh's model axis is ``mesh.model_axis`` and its data axis
        ``mesh.data_axis`` (-1: any)."""
        m = self.config.mesh.model_axis
        if m != ctx.n_model:
            raise ValueError(f"mesh.model_axis={m} but the mesh has {ctx.n_model} model ranks")
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
        seeded with ``seed``; the tables padded to ``n_model`` rows under
        row sharding), on the trainer's device, with gradients on; fresh
        optimizer slots; an empty cache; step 0. Under dlrm_dcnv2 from
        ``models/dlrm.py::init``, its tables drawn on the trainer's device
        (their rows are the config's: ``n_users`` and ``n_items`` are
        not read)."""
        if self.dlrm:
            return self.state_from_params(dlrm.init(seed, self.config.model, self.device), seed)
        params = MultiTaskModel.init(torch.Generator().manual_seed(seed), self.config.model,
                                     n_users, n_items, "cpu",
                                     rows_multiple=self.ctx.n_model if self.rows else 1)
        return self.state_from_params(params, seed)

    def state_from_params(self, params, seed: int) -> TrainState:
        """A step-0 state around given whole params (moved to the trainer's
        device, gradients on), e.g. those of ``params_from_numpy``, with
        fresh slots and, under ``negative_cache``, an empty cache. Under
        row sharding the rank keeps its rows of the two tables (and its
        slots are made from them). Under dlrm_dcnv2 see :meth:`_dlrm_state`."""
        if self.dlrm:
            return self._dlrm_state(params, seed)
        tw = params["towers"]
        self._table_elements = tw["user_table"].numel() + tw["item_table"].numel()

        def own(node, key=""):
            if isinstance(node, dict):
                return {k: own(v, k) for k, v in node.items()}
            if self.rows and key in _SHARDED_KEYS:
                node = shard_rows(self.ctx, node)
            return node.detach().to(self.device, torch.float32).clone().requires_grad_(True)

        params = own(params)
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

    def _dlrm_state(self, params, seed: int) -> TrainState:
        """The dense leaves copied to the trainer's device with gradients on
        and their Adagrad slots; the concatenated table taken as it is
        where it already lies there (no second copy of it), with one
        row-wise accumulator a row, at 0 as FBGEMM's."""
        table = params["embedding"]["table"].detach().to(self.device, torch.float32)
        dense = _map_leaves(dlrm.dense_params(params), lambda t: t.detach().to(self.device, torch.float32)
                            .clone().requires_grad_(True))
        slots = self.optimizer.init(dense)
        slots["accum"]["embedding"] = {"table": torch.zeros((table.shape[0],),
                                                            device=self.device)}
        return TrainState({**dense, "embedding": {"table": table}}, slots, 0, seed + 1, None)

    def _generator(self, state: TrainState) -> torch.Generator:
        """The step's dropout stream; under a mesh the data index is folded
        in (index 0 draws the one-card stream), so ranks draw independent
        masks."""
        seed = state.rng * 1_000_003 + state.step
        if self.ctx is not None:
            seed = (seed + self.ctx.data_index * _RANK_SEED_STRIDE) % (1 << 63)
        self._dropout_gen.manual_seed(seed)
        return self._dropout_gen

    # ---- data parallelism and row-sharded tables ----------------------
    def _loss_axis(self) -> Dict[str, Any]:
        """``MultiTaskModel.loss``'s mesh arguments ({} on one card): the data
        axis, and the tables' lookup under row sharding."""
        ctx = self.ctx
        if ctx is None:
            return {}
        return dict(data_axis=ctx.data_axis, global_negatives=self.config.train.global_negatives,
                    data_axis_size=ctx.n_data, mesh_ctx=ctx, lookup=self._lookup())

    def _a2a(self) -> bool:
        return self.rows and self.config.mesh.lookup_strategy == "a2a"

    def _lookup(self, strategy: Optional[str] = None) -> Optional[Callable]:
        """``lookup(table_shard, ids) -> rows`` of ``strategy`` (the
        configured one by default) under row sharding, else None. a2a sizes
        its capacity from each call's id count and divides the rows'
        cotangent by ``n_model`` (each model replica sends its request's
        cotangent back to the owner); psum, and "xla", take the psum body."""
        if not self.rows:
            return None
        ctx = self.ctx
        if (strategy or self.config.mesh.lookup_strategy) == "a2a":
            factor = self.config.mesh.lookup_capacity_factor
            return lambda table_shard, ids: lookup_a2a(
                ctx, table_shard, ids, a2a_capacity(ids.shape[0], ctx.n_model, factor))[0]
        return make_sharded_lookup_psum(ctx)

    def _overflow(self, tw, batch, neg_ids=None) -> torch.Tensor:
        """The step's ``lookup_overflow`` under a2a: the user and item ids
        (and the explicit negatives, at their own capacity) past their
        buckets, as the JAX step counts them."""
        n, factor = self.ctx.n_model, self.config.mesh.lookup_capacity_factor
        cap = a2a_capacity(batch["user_id"].shape[0], n, factor)
        total = (a2a_overflow(batch["user_id"], tw["user_table"].shape[0], n, cap)
                 + a2a_overflow(batch["movie_id"], tw["item_table"].shape[0], n, cap))
        if neg_ids is not None:
            total = total + a2a_overflow(neg_ids, tw["item_table"].shape[0], n,
                                         a2a_capacity(neg_ids.numel(), n, factor))
        return total.to(torch.float32)

    def _metric_keys(self) -> Tuple[str, ...]:
        if self.dlrm:
            return DLRM_METRIC_KEYS
        return METRIC_KEYS + (("lookup_overflow",) if self._a2a() else ())

    def _is_writer(self) -> bool:
        """Rank 0 (the only rank without a mesh): it writes the run's files
        and evaluates."""
        return self.ctx is None or dist.get_rank() == 0

    def _host_whole(self, tree):
        """The params for rank 0's evaluation and inference bundle. Under
        row sharding: on rank 0, the tree with the sharded tables whole on
        its host (numpy, gathered in chunks over ``model`` from the ranks of
        data index 0, the only ranks that take part; the others return at
        once), and None on every other rank, so no card ever holds a whole
        table. ``tree`` itself otherwise."""
        if not self.rows:
            return tree
        if self.ctx.data_index != 0:
            return None
        whole = ckpt_lib.gather_row_shards(self.ctx, tree)
        return whole if self.ctx.model_index == 0 else None

    def _placed(self, tree):
        """A tree of :meth:`_host_whole` on the trainer's device (rank 0's
        evaluation and ``RetrievalIndex.build``)."""
        if not self.rows:
            return tree
        return ckpt_lib.params_from_numpy(ckpt_lib.params_to_numpy(tree), self.device)

    def _shard_reduce(self) -> Optional[opt_lib.ShardReduce]:
        """The clip's reduction under row sharding: the table shards'
        squared sums are summed over ``model`` (one scalar all-reduce), so
        every rank takes the norm of the whole tables, as the JAX package's
        clip does on the sharded arrays."""
        if not self.rows:
            return None
        ctx = self.ctx
        return _SHARDED_KEYS, lambda sq: collectives.allreduce_sum(ctx, sq, ctx.model_axis)

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detached metrics, mean-reduced over ``data`` in one call under a mesh."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.ctx is None:
            return metrics
        keys = sorted(metrics)
        with span("train.exchange"):
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
        if self.dlrm:
            return self._step_core_dlrm()
        self._check_cache_config(self.config.train.batch_size)
        if not use_explicit_negs and self._resolve_sparse_updates():
            return self._step_core_sparse(class_weights)
        return self._step_core_dense(class_weights, use_explicit_negs)

    def _step_core_dense(self, class_weights, use_explicit_negs: bool = False) -> Callable:
        """The dense step: gradients of every leaf, the full-table update
        (of this rank's shards under row sharding)."""
        cfg = self.config
        shard_reduce = self._shard_reduce()

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            with span("train.step"):
                batch = dict(batch)
                neg_ids = batch.pop("neg_ids") if use_explicit_negs else None
                paths, leaves = zip(*leaves_with_paths(state.params))

                def forward_backward():
                    with span("train.forward"):
                        _, metrics = MultiTaskModel.loss(
                            state.params, cfg.model, batch, generator=self._generator(state),
                            train=True, class_weights=class_weights, neg_item_ids=neg_ids,
                            extra_candidates=self._cache_tuple(state), **self._loss_axis())
                        if self._a2a():
                            metrics["lookup_overflow"] = self._overflow(
                                state.params["towers"], batch, neg_ids)
                    with span("train.backward"):
                        grads = _grads(metrics["loss"], leaves)
                    if self.ctx is not None:
                        # the gradient of the global mean: the mean over
                        # ``data`` of the ranks' (the gathered candidates'
                        # backward already summed the other ranks'
                        # cotangents into this rank's item rows; the model
                        # replicas of a slice hold the same values)
                        with span("train.exchange"):
                            grads = collectives.allreduce_mean_flat(self.ctx, grads)
                    return metrics, dict(zip(paths, grads))

                metrics, grads = self._checked(state, forward_backward)
                new_cache = self._cache_update(state, state.params, batch)  # pre-update params
                with span("train.update"):
                    self.optimizer.update(_tree_from_paths(grads), state.opt_state,
                                          state.params, state.step, shard_reduce)
                self._updated(state)
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
        No [V, D] gradient is ever formed. Under row sharding the virtual
        rows are read through the lookup (values only) and the ids are
        clipped to the whole tables' rows."""
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
            with span("train.step"):
                params = state.params
                tw = params["towers"]

                def forward_backward():
                    with span("train.forward"):
                        movie = batch["movie_id"].long()
                        ids = {"user_table": batch["user_id"].long(), "item_table": movie,
                               "item_bias": movie}
                        ids = {k: v.clamp(0, self._global_rows(tw, k) - 1)
                               for k, v in ids.items()}
                        lookup = self._lookup()
                        with torch.no_grad():
                            if lookup is None:
                                virt = {k: tw[k][ids[k]] for k in self._TABLE_KEYS}
                            else:  # the rows of the unclipped ids, as JAX reads them
                                virt = {"user_table": lookup(tw["user_table"], batch["user_id"]),
                                        "item_table": lookup(tw["item_table"],
                                                             batch["movie_id"]),
                                        "item_bias": tw["item_bias"][ids["item_bias"]]}
                        virt = {k: v.detach().requires_grad_(True) for k, v in virt.items()}
                        vparams = {**params, "towers": {**tw, **virt}}
                        ar = torch.arange(movie.shape[0], dtype=torch.int32,
                                          device=movie.device)
                        vbatch = {**batch, "user_id": ar, "movie_id": ar,
                                  "mask_ids": batch["movie_id"]}
                        # the virtual tables are local [B, D] rows: no lookup in the loss
                        _, metrics = MultiTaskModel.loss(
                            vparams, cfg.model, vbatch, generator=self._generator(state),
                            train=True, class_weights=class_weights,
                            extra_candidates=self._cache_tuple(state),
                            **{**self._loss_axis(), "lookup": None})
                        if self._a2a():
                            metrics["lookup_overflow"] = self._overflow(tw, batch)
                    paths, leaves = zip(*leaves_with_paths(vparams))
                    with span("train.backward"):
                        grads = dict(zip(paths, _grads(metrics["loss"], leaves)))
                    if self.ctx is not None:
                        with span("train.exchange"):
                            grads, ids = self._global_sparse_grads(grads, ids)
                    return metrics, grads, ids

                metrics, grads, ids = self._checked(state, forward_backward)
                new_cache = self._cache_update(state, params, batch)  # pre-update params
                with span("train.update"):
                    self._sparse_apply(state, grads, ids, dense_opt)
                self._updated(state)
                self.step_counts["sparse"] += 1
                return (state._replace(step=state.step + 1, extras=new_cache),
                        self._reduce_metrics(metrics))

        return step_fn

    def _step_core_dlrm(self) -> Callable:
        """The DLRM-DCNv2 step: the batch's bags pooled from the table
        (``embed.bag``), the dense forward and autograd over the dense
        leaves and the bags [B, T, D]; then the dense Adagrad, and the bags'
        gradient back to the looked-up rows of the table with their
        row-wise Adagrad, fused (``embed.bag_bwd``), in place. The metrics
        gain the lookups and the rows updated, counted on the device."""
        cfg = self.config
        layout = self._layout

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            with span("train.step"):
                table = state.params["embedding"]["table"]
                dense = dlrm.dense_params(state.params)
                paths, leaves = zip(*leaves_with_paths(dense))

                def forward_backward():
                    with span("train.forward"):
                        with span("embed.bag"):
                            bags = eb.bag_forward(table, batch["sparse"], layout)
                        bags.requires_grad_(True)
                        logit = dlrm.logits(dense, cfg.model, batch["dense"], bags)
                        metrics = {"loss": dlrm.bce(logit, batch["label"])}
                    with span("train.backward"):
                        grads = torch.autograd.grad(metrics["loss"], [*leaves, bags])
                    return metrics, dict(zip(paths, grads[:-1])), grads[-1]

                metrics, grads, bag_grad = self._checked(state, forward_backward)
                with span("train.update"):
                    self.optimizer.update(_tree_from_paths(grads), state.opt_state,
                                          state.params, state.step)
                    with span("embed.bag_bwd"):
                        metrics["lookups"], metrics["unique_rows"] = \
                            eb.bag_backward_rowwise_adagrad(
                                table, state.opt_state["accum"]["embedding"]["table"],
                                batch["sparse"], bag_grad, layout, self._schedule(state.step))
                self._updated(state)
                self.step_counts["sparse"] += 1
                return state._replace(step=state.step + 1), {k: v.detach()
                                                             for k, v in metrics.items()}

        return step_fn

    def _checked(self, state: TrainState, forward_backward: Callable) -> tuple:
        """``forward_backward()`` -> (metrics, grads, ...); under the NaN
        checks the loss and gradients are checked once, before the caller
        updates anything (a NaN re-runs ``forward_backward`` to name the op
        and raises)."""
        if not nan_checks_enabled():
            return forward_backward()
        with deferred_nan_checks():
            out = forward_backward()
        self._nan_guard.check(state.step, out[0]["loss"], out[1], forward_backward)
        return out

    def _updated(self, state: TrainState) -> None:
        """Under the NaN checks, the params after the step's update, read
        at the next check (or flush)."""
        if nan_checks_enabled():
            self._nan_guard.updated(state.step, state.params)

    def _global_rows(self, tw, key: str) -> int:
        """The rows of table leaf ``key`` as a whole (its shard's times
        ``n_model`` under row sharding)."""
        n = tw[key].shape[0]
        return n * self.ctx.n_model if self.rows and key in _SHARDED_KEYS else n

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
        lazy Adam on their touched rows at the base LR. Under row sharding
        the combined rows (and so the norm) are the global batch's on every
        rank, and each rank writes only the ids its shards own, at ``id - m *
        V / n``; ``item_bias`` is updated whole."""
        t = self.config.train
        table_paths = {("towers", k): k for k in self._TABLE_KEYS}
        comb = {k: opt_lib.combine_duplicate_rows(ids[k], grads[p])
                for p, k in table_paths.items()}
        dense = {p: g for p, g in grads.items() if p not in table_paths}
        scale = None
        if t.clipnorm > 0:
            sq = sum(torch.sum(torch.square(g)) for g in dense.values())
            sq = sq + sum(torch.sum(torch.square(c[1])) for c in comb.values())
            scale = opt_lib.clip_scale(torch.sqrt(sq), t.clipnorm)
            dense = {p: g * scale for p, g in dense.items()}
        dense_opt.update(_tree_from_paths(dense), state.opt_state, state.params, state.step)
        lr = self._schedule(state.step)
        tw, slots = state.params["towers"], state.opt_state
        slot_names = ("accum",) if t.optimizer == "adagrad" else ("mu", "nu")
        for k, (slot_ids, combined, valid) in comb.items():
            held = [tw[k]] + [slots[n]["towers"][k] for n in slot_names]
            kept = None
            if self.rows and k in _SHARDED_KEYS:
                slot_ids, combined, valid, kept = self._owned_slots(slot_ids, combined, valid,
                                                                    held)
            if t.optimizer == "adagrad":
                opt_lib.sparse_adagrad_combined(tw[k], held[1], slot_ids, combined, valid, lr,
                                                grad_scale=scale)
            else:  # adam -> lazy Adam on the touched rows
                opt_lib.sparse_lazy_adam_combined(tw[k], held[1], held[2], slot_ids, combined,
                                                  valid, lr, state.step, grad_scale=scale)
            if kept is not None:
                row, saved, any_owned = kept
                for h, old in zip(held, saved):
                    h[row] = torch.where(any_owned, h[row], old)

    def _owned_slots(self, slot_ids, combined, valid, held):
        """The global batch's combined rows for this rank's table shard
        (``held``: the shard and its slots): the ids it owns at their local
        rows ``id - m * V / n``, the rest invalid. The touched-rows update
        writes slot 0's row in place of every invalid slot, so the first
        owned slot is swapped into slot 0; a shard that owns none would see
        slot 0's row written, so that row of every held tensor is saved.
        -> (slot ids, combined, valid, (row, saved rows, any owned)): the
        caller writes the saved rows back unless a slot was owned."""
        rows = held[0].shape[0]
        local = slot_ids - self.ctx.model_index * rows
        owned = valid & (local >= 0) & (local < rows)
        ar = torch.arange(owned.shape[0], device=owned.device)
        first = torch.argmax(owned.to(torch.int32))  # 0 when none is owned
        swap = torch.where(ar == 0, first, torch.where(ar == first, 0, ar))
        local, combined, owned = local.clamp(0, rows - 1)[swap], combined[swap], owned[swap]
        row = local[:1]
        return local, combined, owned, (row, [h[row] for h in held], owned[0])

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
        item ids. Under a mesh every rank appends the global batch; under
        row sharding the embeddings are read through the step's lookup."""
        if state.extras is None:
            return None
        with span("train.cache_update"):
            cfg = self.config
            tw = params["towers"]
            ids = batch["movie_id"]
            emb = TwoTower.item_embed(tw, ids, cfg.model, train=False, lookup=self._lookup())
            corr = torch.zeros(ids.shape, dtype=torch.float32, device=emb.device)
            if cfg.model.use_item_bias:
                corr = corr + tw["item_bias"][ids.long().clamp(0, tw["item_bias"].shape[0] - 1)]
            if "log_q" in batch:
                corr = corr - batch["log_q"]
            if self.ctx is not None:  # the FIFO gains the global batch, in rank order
                with span("train.exchange"):
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
        (masked) batch in inference mode. Under row sharding every rank
        scores the batch through the psum lookup, exact as the JAX
        package's GSPMD gather (an a2a bucket could drop rows)."""
        cfg = self.config
        lookup = self._lookup("psum")

        @torch.no_grad()
        def eval_fn(params, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            if self.dlrm:
                return {"loss": dlrm.loss(params, cfg.model, batch, self._layout)[0]}
            _, metrics = MultiTaskModel.loss(params, cfg.model, batch, train=False,
                                             class_weights=class_weights, lookup=lookup)
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

        keys = self._metric_keys()

        def epoch_fn(state: TrainState, data: Dict[str, torch.Tensor], epoch: int):
            perm_gen.manual_seed(base * 1_000_003 + epoch)
            perm = torch.randperm(n_rows, generator=perm_gen, device=self.device)
            sums = {k: torch.zeros((), device=self.device) for k in keys}
            for i in range(n_steps):
                idx = perm[i * b + lo:i * b + lo + bl]
                state, metrics = step_fn(state, {k: v[idx] for k, v in data.items()})
                for k in keys:
                    sums[k] += metrics[k]
            return state, {k: v / max(n_steps, 1) for k, v in sums.items()}

        return epoch_fn

    def make_val_epoch(self, class_weights, n_steps: int) -> Callable:
        """-> ``val_fn(params, data) -> metrics``: the mask-weighted mean of
        the loss metrics over ``n_steps`` padded batches (through the psum
        lookup under row sharding, as ``make_eval_step``)."""
        cfg = self.config
        b = cfg.train.batch_size
        lookup = self._lookup("psum")

        keys = ("loss",) if self.dlrm else METRIC_KEYS

        @torch.no_grad()
        def val_fn(params, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            sums = {k: torch.zeros((), device=self.device) for k in keys}
            wsum = torch.zeros((), device=self.device)
            for i in range(n_steps):
                batch = {k: v[i * b:(i + 1) * b] for k, v in data.items()}
                if self.dlrm:
                    metrics = {"loss": dlrm.loss(params, cfg.model, batch, self._layout)[0]}
                else:
                    _, metrics = MultiTaskModel.loss(params, cfg.model, batch, train=False,
                                                     class_weights=class_weights, lookup=lookup)
                w = torch.sum(batch["mask"])
                for k in keys:
                    sums[k] += metrics[k] * w
                wsum += w
            return {k: v / torch.clamp(wsum, min=1.0) for k, v in sums.items()}

        return val_fn

    # ---- checkpoints -------------------------------------------------
    def _state_dict(self, state: TrainState) -> Dict[str, Any]:
        """The checkpointed tree; ``extras`` (the cache) is None and left
        out of the npz when the cache is off, as in the JAX package. Under
        row sharding the tables and their slots stay this rank's shards,
        marked ``RowShards``: ``CheckpointManager.save`` (which every rank
        calls) streams them to rank 0, which writes the one-card npz layout
        without holding a whole table. Under the NaN checks the last
        update's params are checked first, so no NaN state is saved."""
        if nan_checks_enabled():
            self._nan_guard.flush()
        return {"params": self._row_shards(state.params),
                "opt_state": self._row_shards(state.opt_state),
                "step": np.int64(state.step), "rng": np.int64(state.rng),
                "extras": state.extras}

    def _row_shards(self, tree):
        """``tree`` with each row-sharded table leaf marked ``RowShards``
        (under row sharding; ``tree`` itself otherwise)."""
        if not self.rows or not isinstance(tree, dict):
            return tree
        return {k: (ckpt_lib.RowShards(self.ctx, v) if k in _SHARDED_KEYS
                    and isinstance(v, torch.Tensor) else self._row_shards(v))
                for k, v in tree.items()}

    def _row_ranges(self, state: TrainState) -> Optional[Dict[str, Tuple[int, int]]]:
        """The whole-table rows this rank holds, by the checkpoint's key of
        each row-sharded leaf (params and slots), for a restore that reads
        only them; None without row sharding."""
        if not self.rows:
            return None
        ranges = {}
        for name, tree in (("params", state.params), ("opt_state", state.opt_state)):
            for path, leaf in leaves_with_paths(tree):
                if path[-1] in _SHARDED_KEYS:
                    n = leaf.shape[0]
                    m = self.ctx.model_index
                    ranges["/".join((name,) + path)] = (m * n, (m + 1) * n)
        return ranges

    @staticmethod
    def _copy_into(live, saved) -> None:
        """Copy a saved (numpy) tree into the live tensors of the same tree."""
        saved = dict(leaves_with_paths(saved))
        with torch.no_grad():
            for path, t in leaves_with_paths(live):
                t.copy_(torch.from_numpy(np.asarray(saved[path])))

    def _load_state(self, state: TrainState, tree: Dict) -> TrainState:
        """A restored checkpoint into ``state`` (under row sharding restored
        with :meth:`_row_ranges`: the rank's rows of the tables and their
        slots)."""
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
        if self.dlrm:
            return self._train_dlrm(bundle)
        cfg = self.config
        t_cfg = cfg.train
        dev = self.device
        n_users = int(bundle["meta/n_users"])
        n_items = int(bundle["meta/n_movies"])
        logger.info("training: %d users, %d items on %s%s%s", n_users, n_items, dev,
                    "" if self.ctx is None else f", data-parallel over {self.ctx.n_data} ranks",
                    f", tables row-sharded over {self.ctx.n_model} ranks "
                    f"({cfg.mesh.lookup_strategy} lookup)" if self.rows else "")
        if t_cfg.debug_nans:
            enable_nan_checks()
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
            restored = self.ckpt.restore_latest(rows=self._row_ranges(state))
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

        def validate(params) -> Dict[str, float]:
            if resident:
                return {f"val_{k}": float(v) for k, v in val_epoch(params, val_data).items()}
            # the unweighted mean of the val batches' masked means
            v_agg: Dict[str, float] = {}
            v_steps = 0
            for batch in val_batcher.epoch(0):
                metrics = eval_step(params, placer.ready(placer(augment(batch))))
                for k, v in metrics.items():
                    v_agg[k] = v_agg.get(k, 0.0) + float(v)
                v_steps += 1
            return {f"val_{k}": v / max(v_steps, 1) for k, v in v_agg.items()}

        # the first epoch's train steps traced on rank 0, as the JAX package does
        profiler = self._start_profile() if t_cfg.profile and self._is_writer() else None
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
                if nan_checks_enabled():
                    self._nan_guard.flush()
                if profiler is not None:
                    profiler = self._stop_profile(profiler)
                epoch_time = time.time() - t0
                examples_total += n_steps * t_cfg.batch_size
                logs["examples_per_s"] = n_steps * t_cfg.batch_size / max(epoch_time, 1e-9)
                if logs.get("train_lookup_overflow", 0.0) > 0:
                    # overflowing ids train against zero rows: say so, with the knob
                    logger.warning(
                        "a2a lookup overflow: %.1f ids/step (mean) exceeded the per-shard "
                        "exchange capacity and were served zero rows. Raise "
                        "mesh.lookup_capacity_factor (currently %.2f; capacity = ceil(factor "
                        "* B_local / n_shards) per (src, dst) shard pair) until "
                        "lookup_overflow reports 0.", logs["train_lookup_overflow"],
                        cfg.mesh.lookup_capacity_factor)
                val_logs = validate(state.params)
                if nan_checks_enabled():
                    self._nan_guard.check_values("the validation pass", val_logs,
                                                 lambda: validate(state.params), state.step)
                logs.update(val_logs)
                if t_cfg.eval_every_epochs and (epoch + 1) % t_cfg.eval_every_epochs == 0:
                    sample_cfg = dataclasses.replace(
                        cfg.eval, eval_sample=cfg.eval.eval_sample or 20_000, topk=(10,))
                    whole = self._host_whole(state.params)
                    recall = None
                    if self._is_writer():
                        recall = evaluate(self._placed(whole), cfg.model, bundle, "val",
                                          sample_cfg, seed=t_cfg.seed,
                                          dense=val_dense)["recall@10"]
                    del whole
                    logs["val_recall@10"] = self._from_writer(recall)
                if (self.ctx is not None and t_cfg.replication_check_every_epochs
                        and (epoch + 1) % t_cfg.replication_check_every_epochs == 0
                        and self.ctx.n_devices > 1):
                    logs["replica_checksum"] = float(assert_replicated(
                        state.params, self.ctx, skip=_SHARDED_KEYS if self.rows else ())[0])
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
            if profiler is not None:
                self._stop_profile(profiler)
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.ckpt.wait()

        if not preempted and best_params_host is not None:
            self._copy_into(state.params, best_params_host)
        wall = time.time() - t_train0
        self.final_state = state
        # rank 0 (the only rank without a mesh) evaluates and writes; the
        # others take its report and wait for its files at the barrier.
        # Under row sharding the tables are gathered onto its host first.
        writer = self._is_writer()
        whole = None if preempted else self._host_whole(state.params)
        params = self._placed(whole) if writer and not preempted else None
        report = None
        if writer and preempted:
            report = {"preempted": True, "train_wall_time_s": wall,
                      "epochs_run": final_epoch + 1, "resume_step": state.step}
        elif writer:
            report = evaluate(params, cfg.model, bundle, "val", cfg.eval,
                              seed=t_cfg.seed, dense=val_dense)
            report["train_wall_time_s"] = wall
            report["examples_per_s"] = examples_total / max(wall, 1e-9)
            report["epochs_run"] = final_epoch + 1
        if writer:
            self.writer.write_final_metrics(report)
            self.writer.close()
        if writer and not preempted:
            index = RetrievalIndex.build(params["towers"], cfg.model, n_items,
                                         bundle["meta/movie_raw_ids"], device=dev)
            ckpt_lib.save_inference_bundle(
                f"{self.output_dir}/serving", whole["towers"], cfg,
                bundle["meta/user_raw_ids"], bundle["meta/movie_raw_ids"],
                index=index, full_params=whole,
                feature_state=None if engineer is None else engineer.state_dict())
        report = self._from_writer(report)
        if self.ctx is not None:
            dist.barrier()
        return report

    def _train_dlrm(self, bundle: Dict[str, np.ndarray]) -> Dict[str, float]:
        """``train`` for dlrm_dcnv2: a bundle of ``train/`` and ``val/``
        columns ``dense`` [N, dense_in] fp32, ``sparse`` [N, S] int32 (the
        bags side by side, ids local to their tables) and ``label`` [N]
        0/1; the splits on the device; a checkpoint, the train metrics and
        the validation BCE each epoch, early stopping on it with the best
        weights restored, ``--resume`` and ``profile`` as for the two-tower
        model. The report: the final validation BCE and the throughput. No
        serving bundle: the model is a pointwise CTR model, with no
        retrieval index."""
        cfg, t_cfg, dev = self.config, self.config.train, self.device
        if t_cfg.debug_nans:
            enable_nan_checks()
        self.writer.write_config(cfg)
        b = t_cfg.batch_size

        def on_device(arr):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(dev)

        train_data = {c: on_device(bundle[f"train/{c}"]) for c in DLRM_COLUMNS}
        n_rows = train_data["label"].shape[0]
        steps = n_rows // b
        n_val = len(bundle["val/label"])
        val_steps = max(-(-n_val // b), 1)
        pad = val_steps * b - n_val
        val_data = {c: on_device(np.pad(bundle[f"val/{c}"],
                                        [(0, pad)] + [(0, 0)] * (bundle[f"val/{c}"].ndim - 1)))
                    for c in DLRM_COLUMNS}
        val_data["mask"] = on_device(np.pad(np.ones(n_val, np.float32), (0, pad)))
        train_epoch = self.make_train_epoch(None, n_rows, steps)
        val_epoch = self.make_val_epoch(None, val_steps)
        state = self.init_state(0, 0, t_cfg.seed)
        start_epoch = 0
        if t_cfg.resume:
            restored = self.ckpt.restore_latest()
            if restored is not None:
                state = self._load_state(state, restored[1])
                start_epoch = state.step // max(steps, 1)
        logger.info("dlrm_dcnv2: %d tables, %d rows, %d train rows, %d steps/epoch on %s",
                    len(cfg.model.table_rows), sum(cfg.model.table_rows), n_rows, steps, dev)
        best_val, best_host, patience, examples = float("inf"), None, 0, 0
        profiler = self._start_profile() if t_cfg.profile else None
        t0 = time.time()
        try:
            for epoch in range(start_epoch, t_cfg.epochs):
                self.writer.start_epoch()
                t_epoch = time.time()
                state, tmetrics = train_epoch(state, train_data, epoch)
                logs = {f"train_{k}": float(v) for k, v in tmetrics.items()}  # syncs
                if profiler is not None:
                    profiler = self._stop_profile(profiler)
                if nan_checks_enabled():
                    self._nan_guard.flush()
                examples += steps * b
                logs["examples_per_s"] = steps * b / max(time.time() - t_epoch, 1e-9)
                logs.update({f"val_{k}": float(v)
                             for k, v in val_epoch(state.params, val_data).items()})
                self.writer.end_epoch(epoch, logs)
                is_best = logs["val_loss"] < best_val
                if is_best:
                    best_val, patience = logs["val_loss"], 0
                    best_host = ckpt_lib.params_to_numpy(state.params)
                else:
                    patience += 1
                self.ckpt.save(state.step, self._state_dict(state),
                               metrics={"val_loss": logs["val_loss"]}, is_best=is_best)
                if patience >= t_cfg.early_stop_patience:
                    break
        finally:
            if profiler is not None:
                self._stop_profile(profiler)
            self.ckpt.wait()
        if best_host is not None:
            self._copy_into(state.params, best_host)
        wall = time.time() - t0
        self.final_state = state
        report = {"val_loss": best_val, "train_wall_time_s": wall,
                  "examples_per_s": examples / max(wall, 1e-9),
                  "epochs_run": state.step // max(steps, 1)}
        self.writer.write_final_metrics(report)
        self.writer.close()
        return report

    def _start_profile(self) -> torch.profiler.profile:
        """A running ``torch.profiler`` session (the CPU, and the card's
        kernels on CUDA) whose trace goes to ``<output_dir>/profile``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(f"{self.output_dir}/profile"))
        profiler.start()
        return profiler

    def _stop_profile(self, profiler: torch.profiler.profile) -> None:
        """Stop ``profiler`` and write its trace; -> None."""
        profiler.stop()
        logger.info("profiler trace -> %s/profile", self.output_dir)

    def _from_writer(self, value):
        """``value`` as rank 0 computed it, on every rank (a broadcast under
        a mesh)."""
        if self.ctx is None:
            return value
        shared = [value]
        dist.broadcast_object_list(shared, src=0)
        return shared[0]

    def _preempted_anywhere(self) -> bool:
        """Whether SIGTERM or SIGUSR1 reached this process, or under a mesh
        any rank (max-reduced, so every rank saves and stops at one step)."""
        flag = self._preempt_requested
        if self.ctx is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)
