"""DLRM with a DCN V2 interaction, as MLPerf Training's recommendation
benchmark trains it (mlcommons/training ``recommendation_v2/torchrec_dlrm``;
DLRM, Naumov et al., arXiv:1906.00091; DCN V2, Wang et al.,
arXiv:2008.13535). The JAX package has no such model.

* the bottom MLP over the dense features (``dlrm_dense_in`` -> ...
  ``bottom_mlp_dims``, ReLU after every layer, ending at ``embedding_dim``);
* one pooled multi-hot bag a categorical feature (sum pooling) from its
  table: ``ops/embedding_bag.py``, over the one concatenated table
  ``params["embedding"]["table"]``;
* x0 = concat(bottom output, the bags), F = (1 + tables) * embedding_dim;
* ``cross_layers`` low-rank cross layers of rank ``dcn_low_rank_dim``
  (``models/dcn.py::low_rank_cross_stack``);
* the over arch (``over_arch_dims``, ReLU after every layer) and a linear
  layer to one logit; the loss is the mean binary cross-entropy on it.

Under ``mixed_precision`` every matrix product takes bf16 operands with
fp32 sums and an fp32 result, forward and backward
(``layers.linear``); the tables, the bags, the cross's elementwise terms
and the loss are fp32.

Params: ``{"embedding": {"table": [n_rows, D]}, "bottom_mlp": ..., "cross":
..., "over_arch": ...}`` (dense ``w`` is [in, out]). The tables are drawn
on the device from the seed, uniform in +-sqrt(1 / rows) with the rows of
``table_init_rows`` (torchrec's default; a table cut to one card's rows
keeps its published bound); the dense kernels Glorot-uniform (torchrec
takes PyTorch's defaults), biases zero.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import dcn
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.ops import embedding_bag as eb
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device
from recsys_tpu_torch.utils.trace import span


def input_dim(cfg: ModelConfig) -> int:
    """F, the width of x0."""
    return (1 + len(cfg.table_rows)) * cfg.embedding_dim


def dense_params(params: Dict) -> Dict:
    """Every leaf but the table."""
    return {k: v for k, v in params.items() if k != "embedding"}


def init(seed: int, cfg: ModelConfig, device: DeviceLike = "cuda") -> Dict:
    """Params from ``seed``: the concatenated table drawn on ``device`` a
    table at a time, the dense leaves on a CPU generator, then moved."""
    device = resolve_device(device)
    d = cfg.embedding_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.empty((sum(cfg.table_rows), d), dtype=torch.float32, device=device)
    init_rows = cfg.table_init_rows or cfg.table_rows
    lo = 0
    for rows, bound_rows in zip(cfg.table_rows, init_rows):
        lim = (1.0 / bound_rows) ** 0.5
        table[lo:lo + rows].uniform_(-lim, lim, generator=gen)
        lo += rows
    cpu = torch.Generator().manual_seed(seed)
    f = input_dim(cfg)
    return {
        "embedding": {"table": table},
        "bottom_mlp": L.init_mlp(cpu, [cfg.dlrm_dense_in, *cfg.bottom_mlp_dims], device),
        "cross": dcn.init_low_rank_cross(cpu, cfg.cross_layers, f, cfg.dcn_low_rank_dim,
                                         device),
        "over_arch": L.init_mlp(cpu, [f, *cfg.over_arch_dims, 1], device),
    }


def _mlp(p: Dict, x: torch.Tensor, bf16: bool, final_relu: bool) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = L.linear(p[f"layer_{i}"], x, bf16)
        if i < n - 1 or final_relu:
            x = torch.relu(x)
    return x


def logits(params: Dict, cfg: ModelConfig, dense: torch.Tensor,
           bags: torch.Tensor) -> torch.Tensor:
    """dense [B, dense_in] fp32 and the pooled bags [B, T, D] -> [B]
    logits. ``params`` needs only the dense leaves."""
    bf16 = cfg.mixed_precision
    bottom = _mlp(params["bottom_mlp"], dense.float(), bf16, final_relu=True)
    x0 = torch.cat([bottom, bags.reshape(bags.shape[0], -1)], dim=1)
    with span("dlrm.cross"):
        x = dcn.low_rank_cross_stack(params["cross"], x0, bf16)
    return _mlp(params["over_arch"], x, bf16, final_relu=False)[:, 0]


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy of ``logit`` against 0/1 ``label``."""
    return torch.nn.functional.binary_cross_entropy_with_logits(logit, label.float())


def loss(params: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
         layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference-mode loss of a batch ({"dense", "sparse", "label"}, and a
    "mask" to weight its rows) -> (loss, logits): the whole forward, bags
    and all, with no gradient kept for the table."""
    bags = eb.bag_forward(params["embedding"]["table"], batch["sparse"], layout)
    logit = logits(params, cfg, batch["dense"], bags)
    if "mask" not in batch:
        return bce(logit, batch["label"]), logit
    per = torch.nn.functional.binary_cross_entropy_with_logits(
        logit, batch["label"].float(), reduction="none")
    m = batch["mask"]
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0), logit
