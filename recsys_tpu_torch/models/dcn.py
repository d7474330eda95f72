"""Deep & Cross Network (DCNv1, rank-1 cross vectors), in inference and
train mode (the counterpart of ``recsys_tpu/models/dcn.py``).

* cross layers ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``, all L of them
  in one call of :func:`recsys_tpu_torch.ops.dcn_cross.cross_stack` (the
  CUDA kernels on the card, forward and backward, their plain versions on
  the CPU);
* a parallel deep MLP (relu on every layer) over ``dnn_dims``, with
  dropout between its layers in train mode;
* output ``concat(cross_out, deep_out)``.

Numerics follow the JAX package's kernel branch (``use_pallas_dcn=True``)
whatever ``use_pallas_dcn`` says: under ``mixed_precision`` the input is
rounded to bf16, the cross stack runs in fp32 on it and its output is
rounded to bf16 again; the deep branch takes bf16 operands with fp32
accumulation. The JAX package's XLA branch instead runs the cross stack
in bf16, so the two agree only to bf16 tolerance there.

The low-rank cross of DCN V2 (Wang et al., arXiv:2008.13535), which
DLRM-DCNv2 (``models/dlrm.py``) interacts its features with and the JAX
package does not have, is :func:`low_rank_cross_stack`:
``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l`` with ``V_l`` [F -> r] and
no bias, ``W_l`` [r -> F]; its products are GEMMs left to ``torch.mm``
(bf16 operands with fp32 sums under ``mixed_precision``), the rest fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.ops.dcn_cross import cross_stack
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device


def init_low_rank_cross(generator: torch.Generator, n_layers: int, f: int, rank: int,
                        device: DeviceLike = "cuda") -> Dict:
    """``layer_i``: ``v`` [F, r] and ``w`` [r, F] Glorot-uniform (the
    port's layout, [in, out]), ``b`` [F] zeros."""
    device = resolve_device(device)
    return {f"layer_{i}": {"v": L.glorot(generator, (f, rank), device),
                           "w": L.glorot(generator, (rank, f), device),
                           "b": torch.zeros((f,), dtype=torch.float32, device=device)}
            for i in range(n_layers)}


def low_rank_cross_stack(params: Dict, x0: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The low-rank cross layers over x0 [n, F] fp32 -> [n, F] fp32."""
    xl = x0
    for i in range(len(params)):
        p = params[f"layer_{i}"]
        u = L.linear({"w": p["w"], "b": p["b"]}, L.linear({"w": p["v"]}, xl, bf16), bf16)
        xl = x0 * u + xl
    return xl


class DeepCrossNetwork:
    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig, input_dim: int,
             device: DeviceLike = "cuda") -> Dict:
        device = resolve_device(device)
        return {
            "cross": {
                f"layer_{i}": {
                    "w": L.glorot(generator, (input_dim, 1), device)[:, 0].contiguous(),
                    "b": torch.zeros((input_dim,), dtype=torch.float32, device=device),
                }
                for i in range(cfg.cross_layers)
            },
            "deep": L.init_mlp(generator, [input_dim, *cfg.dnn_dims], device),
        }

    @staticmethod
    def output_dim(cfg: ModelConfig, input_dim: int) -> int:
        return input_dim + (cfg.dnn_dims[-1] if cfg.dnn_dims else 0)

    @staticmethod
    def apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bf16 = cfg.mixed_precision
        x0 = L.round_bf16(x) if bf16 else x.float()
        if cfg.cross_layers > 0:
            layers = [params["cross"][f"layer_{i}"] for i in range(cfg.cross_layers)]
            w = torch.stack([p["w"] for p in layers])
            b = torch.stack([p["b"] for p in layers])
            # JAX keeps x0 in bf16, so each branch's gradient into it is
            # rounded to bf16 before the two are added: round_bf16 on the
            # cross input does that here (its value is already bf16)
            xl = cross_stack((L.round_bf16(x0) if bf16 else x0).contiguous(), w, b)
            if bf16:
                xl = L.round_bf16(xl)
        else:
            xl = x0
        if not params["deep"]:
            return xl
        deep = L.mlp(params["deep"], x0, activation=torch.relu,
                     final_activation=torch.relu, bf16=bf16,
                     dropout_rate=cfg.dropout_rate, train=train, generator=generator)
        return torch.cat([xl, deep], dim=-1)
