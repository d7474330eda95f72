"""recsys_tpu_torch — the PyTorch/CUDA port of recsys_tpu.

A second package beside the JAX reference (``recsys_tpu``), written for
one NVIDIA H100: plain PyTorch around hand-written CUDA kernels for
Hopper (``csrc/``), each with a plain PyTorch version that the CPU runs.
It imports neither ``jax`` nor anything of ``recsys_tpu``; it keeps its
own copy of what it needs (``config``, the numpy data layer). Params use
the JAX package's tree layout, so inference bundles load in either
package.

Ported so far: preprocessing and the engineered features (``data``,
``python -m recsys_tpu_torch.preprocess``), single-GPU training
(``train``), evaluation (``retrieval``, ``evaluate``), serving with the
device, host, exported and sharded backends, the micro-batcher, the
asyncio server, hot reload and forked workers (``serve``), the mesh on
``torch.distributed`` with its collectives (``parallel``) and the export of the
retrieve path (``python -m recsys_tpu_torch.export``). ``ROADMAP.md`` lists the
rest.
"""

from recsys_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    MeshConfig,
    ModelConfig,
    RecsysConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = [
    "RecsysConfig",
    "ModelConfig",
    "DataConfig",
    "TrainConfig",
    "MeshConfig",
    "EvalConfig",
    "__version__",
]
