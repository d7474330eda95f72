"""MLA-MoE's model FLOPs (``work/mla_moe.py::train_step``) of the steps
trained in the window, from the program's counters of events, causal
pairs and pairs on held experts a step, over the window and the card's
bf16 peak; nothing in a cell of another model."""

from bench_port.readers import mfu
from bench_port.work.mla_moe import train_step


def read(res, ctx):
    model = ctx.config["model"]
    s = res["stats"]
    if model.get("arch") != "mla_moe" or s.get("assignments_per_step") is None:
        return None
    per = train_step(model, s["events_per_step"], s["pairs_per_step"], s["batch"],
                     s["assignments_per_step"])
    return mfu(per * s["steps"], s["window_s"])
