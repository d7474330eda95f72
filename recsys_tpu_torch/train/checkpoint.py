"""Inference-bundle I/O and the weight bridge between the two packages.

The bundle layout is the JAX package's (``recsys_tpu/train/checkpoint.py``):

* ``encoder.npz`` — two-tower params, keys like ``user_tower/layer_0/w``;
* ``model.npz``   — full params (towers + DCN + heads), keys like
  ``towers/user_tower/layer_0/w``, enabling two-stage rerank;
* ``vocabs.json`` — raw user / item id lists;
* ``config.json`` — :class:`~recsys_tpu_torch.config.RecsysConfig`;
* ``index.npz``   — :class:`~recsys_tpu_torch.retrieval.scorer.RetrievalIndex`.

A dense ``w`` is stored ``[in, out]`` (not ``nn.Linear``'s ``[out, in]``),
and the port keeps it so in memory too: its params are nested dicts of
tensors with exactly the JAX pytree's keys and shapes. So a bundle
written by either package loads in the other, and the bridge below is a
plain leaf-by-leaf conversion.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

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
    return np.asarray(tree)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
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


def save_inference_bundle(
    output_dir: str,
    tower_params: Dict,
    config,
    user_raw_ids: np.ndarray,
    item_raw_ids: np.ndarray,
    index=None,
    full_params: Optional[Dict] = None,
) -> None:
    """Write the serving artifact set (see the module docstring).
    ``tower_params`` / ``full_params`` may hold tensors on any device."""
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, "encoder.npz"),
             **_flatten(params_to_numpy(tower_params)))
    if full_params is not None:
        np.savez(os.path.join(output_dir, "model.npz"),
                 **_flatten(params_to_numpy(full_params)))
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
