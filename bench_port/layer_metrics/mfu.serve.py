"""Model FLOPs of the requests the coalescer served in the window, over
the window and the card's bf16 peak."""

from bench_port.readers import mfu
from bench_port.work.model import serve_request


def read(res, ctx):
    s = res["stats"]
    per = serve_request(ctx.config["model"], ctx.config["data"]["n_items"],
                        ctx.cell["traffic"]["rerank_candidates"])
    return mfu(per * s["served"], s["window_s"])
