"""Checkpoints, inference-bundle I/O and the weight bridge between the
two packages.

The bundle layout is the JAX package's (``recsys_tpu/train/checkpoint.py``):

* ``encoder.npz`` — two-tower params, keys like ``user_tower/layer_0/w``;
* ``model.npz``   — full params (towers + DCN + heads), keys like
  ``towers/user_tower/layer_0/w``, enabling two-stage rerank;
* ``vocabs.json`` — raw user / item id lists;
* ``config.json`` — :class:`~recsys_tpu_torch.config.RecsysConfig`;
* ``index.npz``   — :class:`~recsys_tpu_torch.retrieval.scorer.RetrievalIndex`;
* ``features.npz`` — the fitted ``FeatureEngineer`` state, when the model
  takes engineered dense features (``ModelConfig.dense_features``).

A dense ``w`` is stored ``[in, out]`` (not ``nn.Linear``'s ``[out, in]``),
and the port keeps it so in memory too: its params are nested dicts of
tensors with exactly the JAX pytree's keys and shapes. So a bundle
written by either package loads in the other, and the bridge below is a
plain leaf-by-leaf conversion.

Training checkpoints (:class:`CheckpointManager`) use the JAX package's
npz layout (``<dir>/ckpt_<step>/state.npz`` of ``_flatten``ed keys, a
``metrics.json`` sidecar and a ``best`` alias): one uncompressed zip of
``.npy`` members, which ``np.load`` and both packages' npz restore read;
the port has no orbax. The CBNS cache rides in it as ``extras/emb``,
``extras/ids`` and ``extras/corr``; with the cache off the field is None
and ``_flatten`` leaves it out, as the JAX package's does. Under a process
group of several ranks (the data-parallel trainer: every rank holds the
same state) rank 0 alone writes, synchronously, and every rank restores.

With row-sharded tables no host holds a whole table for a checkpoint (the
JAX package's orbax path, where each process writes and reads its own
shards): the trainer marks each table shard and its slots'
:class:`RowShards`, and ``save`` streams their rows, rank by rank in
chunks (``parallel.sharding.table_chunks``), into their ``.npy`` members
on rank 0's host, which holds one chunk at a time; ``restore(rows=...)``
reads each rank's own rows of those members straight from the file. The inference bundle and the final evaluation take
the whole tables on rank 0's host (:func:`gather_row_shards`), as the JAX
package's ``device_get`` does; the bundle keeps the padded rows.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import struct
import threading
import zipfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from recsys_tpu_torch.parallel.mesh import process_count, process_index
from recsys_tpu_torch.parallel.sharding import gather_table, numpy_dtype, table_chunks
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dict of numpy arrays (a JAX param tree, or a loaded
    ``model.npz``) -> the same tree of tensors on ``device``. Float
    leaves become fp32; integer leaves keep their type."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (host copies)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return None if tree is None else np.asarray(tree)


# the leaves that the trainer splits by rows over ``model``
ROW_SHARDED_KEYS = ("user_table", "item_table")


def gather_row_shards(ctx, tree: Any) -> Any:
    """``tree`` (nested dicts: params, or optimizer slots) with every
    leaf named in ``ROW_SHARDED_KEYS`` gathered whole over ``model``
    (``parallel.sharding.gather_table``): a numpy array on the host of the
    group's first rank, None on the others; the other leaves as they are.
    A collective, which every rank of this rank's ``model`` group calls in
    the same order."""
    if isinstance(tree, dict):
        return {k: (gather_table(ctx, v.detach()) if k in ROW_SHARDED_KEYS
                    and isinstance(v, torch.Tensor) else gather_row_shards(ctx, v))
                for k, v in tree.items()}
    return tree


class RowShards(NamedTuple):
    """A checkpoint leaf split by rows over ``model``: this rank's shard
    (rows ``[m * V / n, (m + 1) * V / n)`` of the whole ``[V, ...]``)."""
    ctx: Any
    shard: torch.Tensor


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, RowShards):
        out[prefix.rstrip("/")] = tree
    elif tree is not None:  # empty leaves are skipped, as in the JAX package
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _host_leaves(tree: Any) -> Any:
    """``tree`` with its tensors copied to the host (``RowShards`` kept)."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    return tree if isinstance(tree, RowShards) else params_to_numpy(tree)


def _write_npz(path: str, flat: Dict[str, Any]) -> None:
    """``np.savez``'s file (uncompressed zip64 ``.npy`` members, in
    ``flat``'s order), with each :class:`RowShards` leaf's member streamed:
    the ``.npy`` header of the whole table, then its rows chunk by chunk
    as ``table_chunks`` brings them to this (the first model) rank."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, v in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if not isinstance(v, RowShards):
                    np.lib.format.write_array(f, v, allow_pickle=False)
                    continue
                shard = v.shard
                shape = (v.ctx.n_model * shard.shape[0],) + tuple(shard.shape[1:])
                np.lib.format.write_array_header_1_0(f, {
                    "descr": np.lib.format.dtype_to_descr(numpy_dtype(shard.dtype)),
                    "fortran_order": False, "shape": shape})
                for _, rows in table_chunks(v.ctx, shard):
                    f.write(np.ascontiguousarray(rows).reshape(-1).view(np.uint8))


def _send_row_shards(flat: Dict[str, Any]) -> None:
    """A rank other than 0's part of a save: the ranks of data index 0
    (rank 0's ``model`` group) send their ``RowShards`` rows, in the
    writer's order."""
    for v in flat.values():
        if isinstance(v, RowShards) and v.ctx.data_index == 0:
            for _ in table_chunks(v.ctx, v.shard):
                pass


def _read_rows(f, info: zipfile.ZipInfo, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of the ``[V, ...]`` ``.npy`` member ``info`` of the
    open zip ``f``, read in place: its local header and ``.npy`` header,
    then ``(hi - lo)`` rows. Raises ``ValueError`` for a compressed member
    or a range outside the array."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{info.filename} is compressed: its rows cannot be read in place")
    f.seek(info.header_offset)
    local = f.read(30)
    if local[:4] != b"PK\x03\x04":
        raise ValueError(f"{info.filename}: no local file header at {info.header_offset}")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}.get(version)
    if read_header is None:
        raise ValueError(f"{info.filename}: .npy version {version} is not read in place")
    shape, fortran, dtype = read_header(f)
    if fortran or not shape or dtype.hasobject:
        raise ValueError(f"{info.filename}: not a C-ordered array of rows")
    if not 0 <= lo <= hi <= shape[0]:
        raise ValueError(f"{info.filename}: rows [{lo}, {hi}) outside its {shape[0]} rows")
    out = np.empty((hi - lo,) + tuple(shape[1:]), dtype)
    f.seek(lo * dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64)), 1)
    if f.readinto(out.reshape(-1).view(np.uint8)) != out.nbytes:
        raise ValueError(f"{info.filename}: the file ends inside rows [{lo}, {hi})")
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class CheckpointManager:
    """Step-indexed checkpoints under ``<dir>/ckpt_<step>`` with keep-N
    rotation, a ``best`` alias and optional background saves.

    ``save`` copies the state to the host before it returns (the trainer
    updates its tensors in place right after); with ``async_save`` only
    the disk write runs on a thread, into ``<path>.tmp`` and then an
    atomic rename, so a crash never leaves a half checkpoint. ``wait``
    finishes a pending write, its sidecars and the rotation."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        # one rank writes; async is single-process only, as in the JAX
        # package (the other ranks do not wait on a background write)
        self._is_writer = process_index() == 0
        self.async_save = async_save and process_count() == 1
        self._pending: Optional[Tuple[int, Optional[Dict], bool, Callable[[], None]]] = None
        self._error: List[BaseException] = []
        if self._is_writer:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}")

    def _write(self, path: str, flat: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_npz(os.path.join(tmp, "state.npz"), flat)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)  # atomic commit

    def save(self, step: int, state: Dict[str, Any], metrics: Optional[Dict] = None,
             is_best: bool = False) -> str:
        """``state``: a nested dict of tensors, arrays, numbers and
        :class:`RowShards`. On a rank other than 0 only its ``RowShards``
        rows are sent (every rank calls ``save`` when there are some)."""
        self.wait()  # at most one write in flight
        path = self._path(step)
        flat = _flatten(_host_leaves(state))  # host copy now (RowShards stream later)
        if not self._is_writer:
            _send_row_shards(flat)
            return path
        if self.async_save and not any(isinstance(v, RowShards) for v in flat.values()):
            def run():
                try:
                    self._write(path, flat)
                except BaseException as e:  # re-raised by wait()
                    self._error.append(e)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            self._pending = (step, metrics, is_best, t.join)
            return path
        self._write(path, flat)
        self._finalize(step, metrics, is_best)
        return path

    def _finalize(self, step: int, metrics: Optional[Dict], is_best: bool) -> None:
        path = self._path(step)
        if metrics is not None:
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        if is_best:
            with open(os.path.join(self.directory, "best"), "w") as f:
                f.write(str(step))
        self._rotate()

    def wait(self) -> None:
        """Block until a pending background save has committed, then write
        its sidecars and rotate; raise what the write raised."""
        if self._pending is None:
            return
        step, metrics, is_best, join = self._pending
        self._pending = None
        join()
        if self._error:
            raise self._error.pop()
        self._finalize(step, metrics, is_best)

    def close(self) -> None:
        self.wait()

    def _rotate(self) -> None:
        steps = self.all_steps()
        best = self.best_step()
        for s in steps[: max(0, len(steps) - self.keep)]:
            if s != best:
                shutil.rmtree(self._path(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        self.wait()
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(r"ckpt_(\d+)", n) for n in os.listdir(self.directory))
                      if m)

    def best_step(self) -> Optional[int]:
        self.wait()
        p = os.path.join(self.directory, "best")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.isdir(self._path(s)):
                return s
        return None

    def restore(self, step: int, rows: Optional[Dict[str, Tuple[int, int]]] = None) -> Dict:
        """The state saved at ``step`` as a nested dict of numpy arrays.
        ``rows`` maps a flattened key (``params/towers/user_table``) to the
        row range ``(lo, hi)`` to read of it (a row-sharded rank's own); the
        other leaves are read whole."""
        self.wait()
        path = os.path.join(self._path(step), "state.npz")
        rows = rows or {}
        flat = {}
        with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
            for info in zf.infolist():
                key = info.filename[:-len(".npy")]
                if key in rows:
                    flat[key] = _read_rows(f, info, *rows[key])
                else:
                    with zf.open(info) as member:
                        flat[key] = np.lib.format.read_array(member, allow_pickle=False)
        missing = set(rows) - set(flat)
        if missing:
            raise KeyError(f"{path} holds no {sorted(missing)}")
        return _unflatten(flat)

    def restore_latest(self, rows: Optional[Dict[str, Tuple[int, int]]] = None
                       ) -> Optional[Tuple[int, Dict]]:
        steps = self.all_steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1], rows)

    def restore_best(self, rows: Optional[Dict[str, Tuple[int, int]]] = None
                     ) -> Optional[Tuple[int, Dict]]:
        s = self.best_step()
        if s is None:
            return self.restore_latest(rows)
        return s, self.restore(s, rows)


def save_inference_bundle(
    output_dir: str,
    tower_params: Dict,
    config,
    user_raw_ids: np.ndarray,
    item_raw_ids: np.ndarray,
    index=None,
    full_params: Optional[Dict] = None,
    feature_state: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write the serving artifact set (see the module docstring).
    ``tower_params`` / ``full_params`` may hold tensors on any device;
    ``feature_state`` is ``FeatureEngineer.state_dict()``."""
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, "encoder.npz"),
             **_flatten(params_to_numpy(tower_params)))
    if full_params is not None:
        np.savez(os.path.join(output_dir, "model.npz"),
                 **_flatten(params_to_numpy(full_params)))
    if feature_state is not None:
        np.savez(os.path.join(output_dir, "features.npz"), **feature_state)
    with open(os.path.join(output_dir, "vocabs.json"), "w") as f:
        json.dump(
            {
                "users": [int(u) for u in user_raw_ids],
                "items": [int(i) for i in item_raw_ids],
            },
            f,
        )
    config.save(os.path.join(output_dir, "config.json"))
    if index is not None:
        index.save(os.path.join(output_dir, "index.npz"))
    logger.info("inference bundle -> %s", output_dir)


def load_encoder_params(output_dir: str) -> Dict:
    """Two-tower params as a numpy tree (``params_from_numpy`` places them)."""
    with np.load(os.path.join(output_dir, "encoder.npz")) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_model_params(output_dir: str) -> Optional[Dict]:
    """Full-model params as a numpy tree; None if the bundle has no
    ``model.npz``."""
    path = os.path.join(output_dir, "model.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_feature_engineer(output_dir: str):
    """The fitted ``FeatureEngineer`` of the bundle; None when the bundle
    has no ``features.npz`` (a model without dense features)."""
    path = os.path.join(output_dir, "features.npz")
    if not os.path.exists(path):
        return None
    from recsys_tpu_torch.data.features import FeatureEngineer

    with np.load(path) as z:
        return FeatureEngineer.from_state({k: z[k] for k in z.files})
