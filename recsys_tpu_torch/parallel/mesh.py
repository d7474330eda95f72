"""The device mesh on ``torch.distributed`` (the counterpart of
``recsys_tpu/parallel/mesh.py``).

One process (rank) owns one card. The ranks form a 2-D
``DeviceMesh`` with the dims ``("data", "model")``:

* ``data``: the batch (data-parallel) axis;
* ``model``: the catalog and embedding-row shard axis; the top-k merge
  and the lookup exchange run on it.

Ranks are laid out ``(data, model)`` row-major, so the ``model`` axis is
adjacent ranks (on one host, NVLink neighbours).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), :func:`maybe_initialize_distributed`
joins the launcher's group: NCCL for a card, gloo for the CPU. Without a
launcher, :func:`make_mesh` starts a one-rank group on a private
in-process store, which is what the JAX package's single-process
``make_mesh`` over ``jax.devices()`` becomes when a process owns one card.
A caller that starts its ranks itself (the tests: gloo ranks on a
``FileStore``) initializes the group before its first ``make_mesh``.

The JAX test helpers ``force_virtual_cpu_devices`` and ``cpu_mesh`` have
no counterpart here: a virtual device is a gloo rank, a CPU process.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the meshes made in this process, by (n_data, n_model, device): every
# rank makes a mesh collectively, once; a later make_mesh of the same
# shape (a reloaded service) takes it again
_MESHES: Dict[Tuple[int, int, str], "MeshContext"] = {}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: DeviceLike = "cuda") -> torch.device:
    """This rank's device: ``"cuda"`` is card ``LOCAL_RANK`` (0 without a
    launcher), made current; ``"cpu"`` is the CPU. Raises as
    ``resolve_device`` does when the card is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def maybe_initialize_distributed(device: DeviceLike = "cuda") -> None:
    """Join the launcher's process group when ``torchrun`` started this
    process (NCCL on a card, gloo on the CPU). A no-op when a group
    exists or no launcher's variables are set."""
    if dist.is_initialized() or not all(v in os.environ for v in _LAUNCHER_VARS):
        return
    dev = rank_device(device)
    dist.init_process_group(_backend(dev), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def world_size(device: DeviceLike = "cuda") -> int:
    """The ranks of the launcher's (or an existing) group, joining it
    first; 1 without a launcher."""
    maybe_initialize_distributed(device)
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A ``DeviceMesh`` seen from one rank: its device, its coordinates
    and the process group of each axis, plus the JAX package's shape and
    per-rank batch bookkeeping."""

    mesh: DeviceMesh
    device: torch.device
    data_axis: str = DATA_AXIS
    model_axis: str = MODEL_AXIS

    def _dim(self, axis: str) -> int:
        return self.mesh.mesh_dim_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.mesh.size(self._dim(axis))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str) -> dist.ProcessGroup:
        """The ranks that share this rank's other coordinate."""
        return self.mesh.get_group(axis)

    @property
    def n_data(self) -> int:
        return self.axis_size(self.data_axis)

    @property
    def n_model(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.axis_index(self.data_axis)

    @property
    def model_index(self) -> int:
        return self.axis_index(self.model_axis)

    @property
    def coordinates(self) -> Tuple[int, int]:
        """(data_index, model_index)."""
        return self.data_index, self.model_index

    def local_batch(self, global_batch: int) -> int:
        if global_batch % self.n_data:
            raise ValueError(
                f"global batch {global_batch} not divisible by data axis {self.n_data}")
        return global_batch // self.n_data


def make_mesh(model_parallel: int = 1, data_parallel: int = -1,
              device: DeviceLike = "cuda") -> MeshContext:
    """A ``(data, model)`` mesh over every rank of the process group.

    ``data_parallel=-1`` means "every rank not used by model
    parallelism". Joins the launcher's group (or starts a one-rank group
    without one) first. ``device="cuda"`` (default) raises when the card
    is absent; a group's backend must suit the device (NCCL for a card,
    gloo for the CPU)."""
    dev = rank_device(device)
    maybe_initialize_distributed(dev)
    backend = _backend(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in str(dist.get_backend()):
        raise ValueError(f"a {dev.type} mesh needs a {backend} process group, "
                         f"this process runs {dist.get_backend()}")
    n = dist.get_world_size()
    if model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"data_parallel({data_parallel}) * model_parallel({model_parallel}) != {n}")
    key = (data_parallel, model_parallel, str(dev))
    ctx = _MESHES.get(key)
    if ctx is None:
        mesh = init_device_mesh(dev.type, (data_parallel, model_parallel),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        ctx = _MESHES[key] = MeshContext(mesh=mesh, device=dev)
        logger.info("mesh: %d ranks -> data=%d model=%d (%s, %s)", n, data_parallel,
                    model_parallel, dev, backend)
    return ctx


def shutdown() -> None:
    """Destroy the process group and forget the meshes made on it. Call it
    before the process exits once a mesh was made on NCCL: a communicator
    left behind can hang the exit."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
