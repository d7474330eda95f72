"""Model FLOPs of the examples trained in the window, over the window and
the card's bf16 peak."""

from bench_port.readers import mfu
from bench_port.work.model import train_example


def read(res, ctx):
    s = res["stats"]
    per = train_example(ctx.config["model"], s["batch"], s["n_candidates"])
    return mfu(per * s["examples"], s["window_s"])
