"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU data sheet: dense rates without sparsity, at the 700 W board limit).
A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load; every run prints its card's limit beside its numbers."""

BF16_FLOPS = 989e12   # bf16 / fp16 tensor cores, dense
FP32_FLOPS = 67e12    # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

PEAKS = {"bf16": BF16_FLOPS, "fp32": FP32_FLOPS}


def bound_s(flops: float, n_bytes: float, precision: str):
    """-> (least seconds, "flops" or "bytes"): the larger of the operations
    over the peak of ``precision`` and the bytes over the HBM rate."""
    t_ops = flops / PEAKS[precision]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
