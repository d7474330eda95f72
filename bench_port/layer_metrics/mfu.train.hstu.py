"""HSTU's model FLOPs (``work/hstu.py::train_step``) of the steps trained in
the window, from the program's counters of events and causal pairs a
step, over the window and the card's bf16 peak; nothing in a cell of
another model."""

from bench_port.readers import mfu
from bench_port.work.hstu import train_step


def read(res, ctx):
    model = ctx.config["model"]
    s = res["stats"]
    if model.get("arch") != "hstu" or s.get("events_per_step") is None:
        return None
    per = train_step(model, s["events_per_step"], s["pairs_per_step"], s["batch"])
    return mfu(per * s["steps"], s["window_s"])
