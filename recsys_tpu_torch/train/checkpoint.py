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
``metrics.json`` sidecar and a ``best`` alias); the port has no orbax.
The CBNS cache rides in it as ``extras/emb``, ``extras/ids`` and
``extras/corr``; with the cache off the field is None and ``_flatten``
leaves it out, as the JAX package's does. Under a process group of
several ranks (the data-parallel trainer: every rank holds the same
state) rank 0 alone writes, synchronously, and every rank restores.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from recsys_tpu_torch.parallel.mesh import process_count, process_index
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


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:  # empty leaves are skipped, as in the JAX package
        out[prefix.rstrip("/")] = np.asarray(tree)
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

    def _write(self, path: str, flat: Dict[str, np.ndarray]) -> None:
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)  # atomic commit

    def save(self, step: int, state: Dict[str, Any], metrics: Optional[Dict] = None,
             is_best: bool = False) -> str:
        """``state``: a nested dict of tensors, arrays and numbers. A no-op
        on a rank other than 0."""
        self.wait()  # at most one write in flight
        path = self._path(step)
        if not self._is_writer:
            return path
        flat = _flatten(params_to_numpy(state))  # host copy now
        if self.async_save:
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

    def restore(self, step: int) -> Dict:
        """The state saved at ``step`` as a nested dict of numpy arrays."""
        self.wait()
        with np.load(os.path.join(self._path(step), "state.npz")) as z:
            return _unflatten({k: z[k] for k in z.files})

    def restore_latest(self) -> Optional[Tuple[int, Dict]]:
        steps = self.all_steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1])

    def restore_best(self) -> Optional[Tuple[int, Dict]]:
        s = self.best_step()
        if s is None:
            return self.restore_latest()
        return s, self.restore(s)


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
