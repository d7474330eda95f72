"""Fused DCN cross stack: the CUDA kernel ``csrc/dcn_cross.cu`` and its
plain PyTorch version (the port of ``recsys_tpu/ops/pallas/dcn_cross.py``,
forward only; the backward kernel comes with the training slice).

Computes ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l`` for all L layers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from recsys_tpu_torch.ops import _build

MAX_FEATURES = 1024  # the kernel keeps F/32 <= 32 values per lane in registers


def dcn_cross_reference(x0: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch layer loop of the same recurrence (fp32)."""
    xl = x0
    for l in range(w.shape[0]):
        s = torch.sum(xl * w[l][None, :], dim=1, keepdim=True)
        xl = x0 * s + b[l][None, :] + xl
    return xl


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library().dcn_cross_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dcn_cross(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x0 [n, F] fp32, w and b [L, F] fp32 -> [n, F] fp32.

    CPU tensors take :func:`dcn_cross_reference`; CUDA tensors launch the
    kernel (one launch for all L layers) or raise."""
    if x0.device.type == "cpu":
        return dcn_cross_reference(x0, w, b)
    if x0.device.type != "cuda":
        raise ValueError(f"dcn_cross: unsupported device {x0.device}")
    if x0.dim() != 2 or w.dim() != 2 or w.shape != b.shape or w.shape[1] != x0.shape[1]:
        raise ValueError(
            f"dcn_cross: want x0 [n, F], w and b [L, F]; got {tuple(x0.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, f = x0.shape
    if f > MAX_FEATURES:
        raise ValueError(f"dcn_cross: F={f} exceeds the kernel's {MAX_FEATURES}")
    for name, t in (("x0", x0), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.device != x0.device:
            raise ValueError(f"dcn_cross: {name} must be fp32 on {x0.device}")
    x0, w, b = x0.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty_like(x0)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x0.data_ptr(), w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), None, n, f, w.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"dcn_cross kernel launch failed: cudaError {err}")
    if n:
        dcn_cross.launches += 1
    return out


dcn_cross.launches = 0
