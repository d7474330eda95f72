"""Minimal functional NN core: dense / MLP / dropout / L2 over plain dicts
of tensors (the counterpart of ``recsys_tpu/models/layers.py``).

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


class _MatmulBf16(torch.autograd.Function):
    """``x @ w`` of bf16 operands with fp32 products, sums and result, in
    the forward and in both products of the backward (the incoming
    gradient rounded to bf16 as their operand). On the card each product
    is one bf16 GEMM (``torch.mm`` with ``out_dtype=float32``); elsewhere
    an fp32 product of the rounded operands, which is exact in fp32 too."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        return _mm_bf16(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        gx = _mm_bf16(gb, wb.t()) if ctx.needs_input_grad[0] else None
        return gx, _mm_bf16(xb.t(), gb) if ctx.needs_input_grad[1] else None


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def linear(p: Params, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``x @ w (+ b)`` of a 2-D ``x`` with an fp32 output; ``bf16=True``
    takes bf16 operands in the forward and the backward alike
    (:class:`_MatmulBf16`), where :func:`dense` multiplies rounded operands
    in fp32. A leaf without ``b`` adds no bias."""
    y = _MatmulBf16.apply(x, p["w"]) if bf16 else torch.mm(x.float(), p["w"])
    return y + p["b"] if "b" in p else y


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
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dense layers with ``activation`` between them and
    ``final_activation`` after the last; in train mode, dropout after
    every layer but the last."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"layer_{i}"], x, bf16)
        last = i == n - 1
        act = final_activation if last else activation
        if act is not None:
            x = act(x)
        if dropout_rate > 0.0 and train and not last:
            if generator is None:
                raise ValueError("dropout in train mode needs a torch.Generator")
            x = dropout(generator, x, dropout_rate)
    return x


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``, as the JAX package does. The mask is drawn from
    ``generator``, which must live on ``x``'s device (its stream is not
    JAX's: parity tests run with dropout 0)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def l2_penalty(params, scale: float) -> torch.Tensor:
    """``scale`` times the sum of squared ``w`` leaves of a nested dict
    (dense kernels only, biases excluded), leaves in sorted-key order."""
    leaves = []

    def walk(node):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                walk(value)
            elif key == "w":
                leaves.append(value)

    walk(params)
    if not leaves:
        return torch.zeros(())
    return scale * sum(torch.sum(torch.square(w)) for w in leaves)
