"""The mesh on ``torch.distributed``, its collectives and batch placement
(the counterpart of ``recsys_tpu/parallel``)."""

from recsys_tpu_torch.parallel.mesh import MeshContext, make_mesh
from recsys_tpu_torch.parallel.sharding import shard_batch

__all__ = ["make_mesh", "MeshContext", "shard_batch"]
