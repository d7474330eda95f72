"""Ahead-of-time export of the serving retrieve path (the counterpart of
``recsys_tpu/serve/export.py``, which serializes StableHLO with
``jax.export``).

The artifact is a ``torch.export`` program, saved with
``torch.export.save``: user tower -> L2 normalize -> ``torch.matmul``
against the normalized catalog -> ``torch.topk``, with the trained tower
weights and the catalog as buffers of the program. A ctypes kernel cannot
be traced, so the artifact's top-k is ``torch.topk``, as the JAX
artifact's is ``lax.top_k`` and not its Pallas kernel.

* the batch dimension is dynamic (a ``torch.export.Dim``): one artifact
  serves any query batch;
* the program is saved on the CPU and :func:`load_exported` moves it to
  the device it is asked for, so the same bytes answer on ``cpu`` and
  ``cuda``;
* ``k`` is fixed at export time.

Usage::

    python -m recsys_tpu_torch.export --model_dir <bundle> [--k 10]
    fn = load_exported("<bundle>/retrieve.pt2", "cuda")
    scores, item_idx = fn(user_dense_ids)       # [B] int32 -> [B, k] x 2

The two packages' artifact formats differ (``retrieve.pt2`` here,
``retrieve.hlo`` there), so both can sit in one bundle directory; the
fingerprint of the bundle they were built from is the same.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops.topk_flash import l2_normalize
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train.checkpoint import load_encoder_params, params_from_numpy
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# the devices the saved program answers on (load_exported moves it)
_PLATFORMS = ("cpu", "cuda")
# bundle files whose contents the artifact holds (weights, catalog) or
# that shape its calling convention (config): the JAX package's list
_FINGERPRINT_FILES = ("encoder.npz", "index.npz", "config.json")
DEFAULT_ARTIFACT = "retrieve.pt2"
# the batch size the program is traced at: 2 or more, or the exporter
# specialises the batch dimension to 1
_TRACE_BATCH = 2


def bundle_fingerprint(model_dir: str) -> str:
    """sha256 over the name and bytes of each of ``_FINGERPRINT_FILES``,
    the JAX package's hash: both packages stamp the same hex for a bundle.
    Stamped into the export metadata and checked when the service loads
    the artifact, so a bundle retrained or rebuilt after the export is
    refused, not served with stale weights or catalog order."""
    h = hashlib.sha256()
    for name in _FINGERPRINT_FILES:
        h.update(name.encode())
        with open(os.path.join(model_dir, name), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


class _Retrieve(torch.nn.Module):
    """ids [B] int32 -> (cosine or raw-dot scores [B, k] fp32, catalog
    rows [B, k] int32). The user tower's leaves and the catalog are
    buffers; the tower runs as ``TwoTower.user_embed`` does."""

    def __init__(self, user_params: Dict, items_t: torch.Tensor, cfg: ModelConfig,
                 normalize: bool, k: int):
        super().__init__()
        self.cfg, self.normalize, self.k = cfg, normalize, k
        self.n_layers = len(user_params["user_tower"])
        self.register_buffer("user_table", user_params["user_table"])
        for i in range(self.n_layers):
            layer = user_params["user_tower"][f"layer_{i}"]
            self.register_buffer(f"layer_{i}_w", layer["w"])
            self.register_buffer(f"layer_{i}_b", layer["b"])
        self.register_buffer("items_t", items_t)

    def forward(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        params = {"user_table": self.user_table, "user_tower": {
            f"layer_{i}": {"w": getattr(self, f"layer_{i}_w"),
                           "b": getattr(self, f"layer_{i}_b")}
            for i in range(self.n_layers)}}
        u = TwoTower.user_embed(params, ids, self.cfg)
        if self.normalize:
            u = l2_normalize(u)
        scores, idx = torch.topk(torch.matmul(u, self.items_t), self.k, dim=1)
        return scores, idx.to(torch.int32)


def build_retrieve_fn(model_dir: str, k: int = 10,
                      device: DeviceLike = "cuda") -> torch.nn.Module:
    """The retrieve module of a bundle on ``device``: the user tower's
    weights and the ready catalog (normalized once when the index is
    cosine, as the service's exact route has it), ``k`` fixed."""
    dev = resolve_device(device)
    cfg = RecsysConfig.load(os.path.join(model_dir, "config.json"))
    enc = load_encoder_params(model_dir)
    user = params_from_numpy({"user_table": enc["user_table"],
                              "user_tower": enc["user_tower"]}, dev)
    index = RetrievalIndex.load(os.path.join(model_dir, "index.npz"), dev)
    n_items = index.item_embeddings_np.shape[0]
    if not 0 < k <= n_items:
        raise ValueError(f"k={k} must lie in [1, {n_items}] (the catalog's size)")
    items_t = index._catalog_ready().T.contiguous()
    return _Retrieve(user, items_t, cfg.model, index.normalize, k).eval()


def export_retrieve(model_dir: str, out_path: str, k: int = 10,
                    device: DeviceLike = "cuda") -> dict:
    """Trace the retrieve path on ``device`` with a dynamic batch, move
    the program to the CPU and save it to ``out_path``; returns the
    metadata, also written to ``<out_path>.json`` with the JAX package's
    keys."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    module = build_retrieve_fn(model_dir, k=k, device=dev)
    batch = torch.export.Dim("batch", min=1, max=1 << 20)
    example = torch.zeros((_TRACE_BATCH,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        program = torch.export.export(module, (example,), dynamic_shapes=({0: batch},))
    program = move_to_device_pass(program, "cpu")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)
    meta = {
        "k": k,
        "model_dir": model_dir,
        "platforms": list(_PLATFORMS),
        "calling_convention": "user_dense_ids[int32, b] -> "
                              "(scores[f32, b, k], item_idx[int32, b, k])",
        "bytes": os.path.getsize(out_path),
        "source_fingerprint": bundle_fingerprint(model_dir),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    logger.info("exported retrieve(k=%d) on %s -> %s (%d bytes)",
                k, dev, out_path, meta["bytes"])
    return meta


def load_exported(path: str, device: DeviceLike = "cuda") -> Callable:
    """The saved program on ``device`` (raises if the card is asked for
    and absent) -> ``fn(ids) -> (scores, item_idx)`` as numpy arrays;
    needs none of the package's model code."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    module = move_to_device_pass(torch.export.load(path), dev).module()

    @torch.no_grad()
    def fn(user_dense_ids) -> Tuple[np.ndarray, np.ndarray]:
        ids = torch.as_tensor(np.asarray(user_dense_ids, np.int32).reshape(-1), device=dev)
        scores, idx = module(ids)
        return scores.cpu().numpy(), idx.cpu().numpy()

    return fn
