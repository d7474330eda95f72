"""Device resolution for every entry point of the port (the counterpart
of ``recsys_tpu/utils/platform.py``).

Entry points take ``device="cuda"`` by default. Asking for the card
where there is none raises: nothing falls back to the CPU unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``; raises
    ``RuntimeError`` if a CUDA device is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
        # the fp32 selection contract of exact top-k (and the fp32 cross
        # stack) needs full-precision fp32 products: say so explicitly
        # rather than rely on PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use cuda or cpu")
    return dev
