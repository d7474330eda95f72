"""Fused DCN cross stack: the CUDA kernels of ``csrc/dcn_cross.cu``
(forward and backward) and their plain PyTorch versions (the port of
``recsys_tpu/ops/pallas/dcn_cross.py``).

Computes ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l`` for all L layers.
:func:`cross_stack` is the entry point of the model: under autograd it
runs :class:`DCNCrossFunction` (the forward kernel saving each layer's
input, the backward kernel for the hand-derived VJP), otherwise the
forward kernel alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check

MAX_FEATURES = 1024  # the kernels keep F/32 <= 32 values per lane in registers
# the backward kernels' 8 warps each hand dw and db ([L, F] fp32) to the
# block's sum through shared memory: 64 * L * F bytes, at most what one
# block may have
_BWD_WARPS = 8
MAX_BWD_SHARED_BYTES = 232_448
_BWD_BLOCKS_PER_SM = 2  # the shared-memory kernel's blocks per SM
# the backward keeps each lane's columns of dw and db in registers up to
# this many layers and features (2 L F / 32 floats a lane), else in shared
# memory
MAX_REG_LAYERS = 4
MAX_REG_FEATURES = 256


class DcnBwdPlan(NamedTuple):
    """How the backward runs: dw and db in registers (``registers``) or in
    shared memory, over ``n_blocks`` blocks of 8 warps (one row a warp at a
    time), whose partials a second kernel adds."""
    registers: bool
    n_blocks: int


def bwd_plan(n: int, f: int, n_layers: int, n_sm: int) -> DcnBwdPlan:
    """The backward's plan on a card of ``n_sm`` SMs: the register kernel
    (one block per SM: two rows of registers a warp) where L <=
    ``MAX_REG_LAYERS`` and F <= ``MAX_REG_FEATURES`` (the flagship's 3 x
    256), else the shared-memory one (``_BWD_BLOCKS_PER_SM`` per SM); as
    many blocks as the rows need, at most those."""
    registers = n_layers <= MAX_REG_LAYERS and f <= MAX_REG_FEATURES
    per_sm = 1 if registers else _BWD_BLOCKS_PER_SM
    return DcnBwdPlan(registers, max(1, min(-(-n // _BWD_WARPS), per_sm * n_sm)))


def dcn_cross_reference(x0: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch layer loop of the same recurrence (fp32)."""
    return _reference_forward(x0, w, b)[0]


def _reference_forward(x0, w, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (output, resid [L, n, F]: each layer's input x_l)."""
    xl = x0
    resid = []
    for l in range(w.shape[0]):
        resid.append(xl)
        s = torch.sum(xl * w[l][None, :], dim=1, keepdim=True)
        xl = x0 * s + b[l][None, :] + xl
    return xl, torch.stack(resid) if resid else x0.new_empty((0,) + x0.shape)


def dcn_cross_bwd_reference(x0: torch.Tensor, w: torch.Tensor, resid: torch.Tensor,
                            g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hand-derived VJP (the TPU kernel's
    ``_bwd_kernel``): -> (dx0 [n, F], dw [L, F], db [L, F])."""
    dx0 = torch.zeros_like(x0)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    for l in range(w.shape[0] - 1, -1, -1):
        xl = resid[l]
        s = torch.sum(xl * w[l][None, :], dim=1, keepdim=True)
        t = torch.sum(g * x0, dim=1, keepdim=True)
        dw[l] = torch.sum(t * xl, dim=0)
        db[l] = torch.sum(g, dim=0)
        dx0 = dx0 + g * s
        g = g + t * w[l][None, :]
    return dx0 + g, dw, db


def _check(x0, w, b, what: str) -> None:
    if x0.dim() != 2 or w.dim() != 2 or w.shape != b.shape or w.shape[1] != x0.shape[1]:
        raise ValueError(
            f"{what}: want x0 [n, F], w and b [L, F]; got {tuple(x0.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}")
    if x0.shape[1] > MAX_FEATURES:
        raise ValueError(f"{what}: F={x0.shape[1]} exceeds the kernel's {MAX_FEATURES}")
    for name, t in (("x0", x0), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.device != x0.device:
            raise ValueError(f"{what}: {name} must be fp32 on {x0.device}")


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().dcn_cross_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().dcn_cross_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@kernel_nan_check("kernel row 2 dcn_cross (the cross stack's forward)")
def _forward(x0, w, b, keep_resid: bool):
    """The forward wrapper: -> (out, resid or None)."""
    if x0.device.type == "cpu":
        out, resid = _reference_forward(x0, w, b)
        return out, (resid if keep_resid else None)
    if x0.device.type != "cuda":
        raise ValueError(f"dcn_cross: unsupported device {x0.device}")
    _check(x0, w, b, "dcn_cross")
    n, f = x0.shape
    x0, w, b = x0.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty_like(x0)
    resid = (torch.empty((w.shape[0], n, f), dtype=torch.float32, device=x0.device)
             if keep_resid else None)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_launcher()(x0.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                              resid.data_ptr() if resid is not None else None,
                              n, f, w.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"dcn_cross kernel launch failed: cudaError {err}")
    if n:
        dcn_cross.launches += 1
    return out, resid


def dcn_cross(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x0 [n, F] fp32, w and b [L, F] fp32 -> [n, F] fp32.

    CPU tensors take :func:`dcn_cross_reference`; CUDA tensors launch the
    forward kernel (one launch for all L layers) or raise."""
    return _forward(x0, w, b, keep_resid=False)[0]


dcn_cross.launches = 0


@kernel_nan_check("kernel row 3 dcn_cross_bwd (the cross stack's backward)")
def dcn_cross_bwd(x0: torch.Tensor, w: torch.Tensor, resid: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of the cross stack: x0 [n, F], w [L, F], resid [L, n, F] (the
    forward's saved layer inputs), g [n, F] -> (dx0, dw, db), all fp32.

    CPU tensors take :func:`dcn_cross_bwd_reference`; CUDA tensors launch
    the backward kernel of :func:`bwd_plan` and its partial-sum reduction
    or raise."""
    if x0.device.type == "cpu":
        return dcn_cross_bwd_reference(x0, w, resid, g)
    if x0.device.type != "cuda":
        raise ValueError(f"dcn_cross_bwd: unsupported device {x0.device}")
    _check(x0, w, w, "dcn_cross_bwd")
    n, f = x0.shape
    n_layers = w.shape[0]
    if resid.shape != (n_layers, n, f) or g.shape != x0.shape:
        raise ValueError(
            f"dcn_cross_bwd: want resid {(n_layers, n, f)} and g {(n, f)}; got "
            f"{tuple(resid.shape)} and {tuple(g.shape)}")
    for name, t in (("resid", resid), ("g", g)):
        if t.dtype != torch.float32 or t.device != x0.device:
            raise ValueError(f"dcn_cross_bwd: {name} must be fp32 on {x0.device}")
    if _BWD_WARPS * 2 * n_layers * f * 4 > MAX_BWD_SHARED_BYTES:
        raise ValueError(
            f"dcn_cross_bwd: L*F = {n_layers * f} needs more shared memory than a "
            f"block has (at most {MAX_BWD_SHARED_BYTES // (_BWD_WARPS * 8)})")
    if n == 0 or n_layers == 0:
        return torch.zeros_like(x0) + g, torch.zeros_like(w), torch.zeros_like(w)
    x0, w, resid, g = x0.contiguous(), w.contiguous(), resid.contiguous(), g.contiguous()
    plan = bwd_plan(n, f, n_layers, _sm_count(x0.device.index))
    dx0 = torch.empty_like(x0)
    part = torch.empty((plan.n_blocks, 2, n_layers, f), dtype=torch.float32, device=x0.device)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(x0.data_ptr(), w.data_ptr(), resid.data_ptr(), g.data_ptr(),
                              dx0.data_ptr(), part.data_ptr(), dw.data_ptr(),
                              db.data_ptr(), n, f, n_layers, plan.n_blocks,
                              int(plan.registers), stream)
    if err != 0:
        raise RuntimeError(f"dcn_cross_bwd kernel launch failed: cudaError {err}")
    dcn_cross_bwd.launches += 1
    return dx0, dw, db


dcn_cross_bwd.launches = 0


class DCNCrossFunction(torch.autograd.Function):
    """The cross stack under autograd: the forward kernel keeps each
    layer's input ([L, n, F]) and the backward runs :func:`dcn_cross_bwd`
    (the counterpart of the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x0, w, b):
        out, resid = _forward(x0, w, b, keep_resid=True)
        ctx.save_for_backward(x0, w, resid)
        return out

    @staticmethod
    def backward(ctx, g):
        x0, w, resid = ctx.saved_tensors
        return dcn_cross_bwd(x0, w, resid, g.contiguous())


def cross_stack(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                ) -> torch.Tensor:
    """The model's cross stack: :class:`DCNCrossFunction` when a gradient
    is wanted, else the forward alone (no saved layer inputs)."""
    if torch.is_grad_enabled() and (x0.requires_grad or w.requires_grad or b.requires_grad):
        return DCNCrossFunction.apply(x0, w, b)
    return dcn_cross(x0, w, b)
