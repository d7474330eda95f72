"""Minimal functional NN core: dense / MLP over plain dicts of tensors
(the counterpart of ``recsys_tpu/models/layers.py``).

Params are nested dicts of fp32 tensors with the JAX package's keys and
layout (a dense ``w`` is ``[in, out]``), so bundles cross between the
packages unchanged.

Rounding points follow the JAX package exactly. There a dense layer is
``jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32) + b``:
bf16 operands, fp32 products and accumulation, an **fp32 output**, and
an fp32 bias. A bf16 ``torch.matmul`` would round its output to bf16, so
here the operands are rounded to bf16 and multiplied in fp32: a product
of two bf16 values is exact in fp32, and only the summation order can
differ from XLA's. That matmul is a plain product, left to
``torch.matmul`` as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def glorot(generator: torch.Generator, shape,
           device: DeviceLike = "cuda") -> torch.Tensor:
    """Glorot-uniform fp32 init, fan_in = shape[0], fan_out = shape[-1],
    drawn on the CPU from ``generator`` and placed on ``device``."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * lim) - lim).to(resolve_device(device))


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int,
               device: DeviceLike = "cuda") -> Params:
    device = resolve_device(device)
    return {
        "w": glorot(generator, (in_dim, out_dim), device),
        "b": torch.zeros((out_dim,), dtype=torch.float32, device=device),
    }


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to fp32 (round-to-nearest-even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def dense(p: Params, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``x @ w + b`` with an fp32 output; ``bf16=True`` rounds both
    operands to bf16 first (the JAX ``compute_dtype=bfloat16`` path)."""
    w = p["w"]
    if bf16:
        x, w = round_bf16(x), round_bf16(w)
    return torch.matmul(x.float(), w) + p["b"]


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             device: DeviceLike = "cuda") -> Dict[str, Params]:
    """dims = [in, h1, ..., out]."""
    device = resolve_device(device)
    return {
        f"layer_{i}": init_dense(generator, dims[i], dims[i + 1], device)
        for i in range(len(dims) - 1)
    }


def mlp(
    p: Dict[str, Params],
    x: torch.Tensor,
    activation: Callable = torch.relu,
    final_activation: Optional[Callable] = None,
    bf16: bool = False,
) -> torch.Tensor:
    """Inference-mode MLP (dropout arrives with the training slice)."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"layer_{i}"], x, bf16)
        act = final_activation if i == n - 1 else activation
        if act is not None:
            x = act(x)
    return x
