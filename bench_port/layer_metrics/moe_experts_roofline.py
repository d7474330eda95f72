"""The routed experts (``ops/moe.py``'s ``RoutedExperts``: kernel row 16's
grouped products with their gathers, transposes, SwiGLU and combine, the
backward's recomputed forward among them), forward and backward, bound by
their products at the bf16 peak over the (token, held expert) pairs of a
MoE layer: the step's counter ``moe_assignments`` (summed over the MoE
layers, read after the window) over the MoE layers, the same for each
call (the step keeps its counts on the device, so the spans cannot carry
them)."""

from bench_port import readers_dlrm
from bench_port.work.mla_moe import moe_experts


def read(res, ctx):
    pairs = res.get("stats", {}).get("assignments_per_step")
    model = getattr(ctx, "config", {}).get("model", {})
    if pairs is None or model.get("arch") != "mla_moe":
        return None
    layers = model["mla_layers"] - model["mla_dense_layers"]
    return readers_dlrm.roofline(res, "moe_experts", moe_experts, pairs=pairs / layers)
