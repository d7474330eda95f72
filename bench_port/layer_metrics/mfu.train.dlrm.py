"""DLRM-DCNv2's model FLOPs (``work/dlrm.py::train_example``) of the
examples trained in the window, over the window and the card's bf16 peak;
nothing in a cell of another model."""

from bench_port.readers import mfu
from bench_port.work.dlrm import train_example


def read(res, ctx):
    model = ctx.config["model"]
    if model.get("arch") != "dlrm_dcnv2":
        return None
    s = res["stats"]
    return mfu(train_example(model) * s["examples"], s["window_s"])
