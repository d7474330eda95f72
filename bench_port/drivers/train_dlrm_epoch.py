"""DLRM-DCNv2 training over device-resident data through
``Trainer.make_train_epoch``.

Set-up: the epoch's rows from the seed, made on the card
(``dlrm_datagen.batches``), the weights drawn on the card from the seed,
one ``Trainer`` and one state made by ``Trainer.state_from_params`` (which
takes the table as it lies, with no second copy). That state takes three
checked steps through the trainer's epoch function, one batch each, on
three disjoint batches of rows drawn from the seed (these are the warm-up
too), and then the window: whole epochs of the same epoch function over
every row until ``--seconds`` have passed, ending in a device sync; the
step's counters (lookups and rows updated a step) are read once, after
it. Afterwards, with the program's state freed, the plain reference
(``reference/dlrm.py``) follows the three checked steps from the same
weights and rows, a block of rows at a time.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np


def _config(ctx):
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig

    cfg, tr = ctx.config, ctx.cell["traffic"]
    t = cfg["train"]
    train = TrainConfig(batch_size=tr["batch"], optimizer=t["optimizer"],
                        learning_rate=t["learning_rate"], lr_decay_rate=t["lr_decay_rate"],
                        clipnorm=t["clipnorm"], seed=int(ctx.seed) % (1 << 31),
                        async_checkpoint=False)
    return RecsysConfig(model=ModelConfig(**cfg["model"]), train=train)


def inputs(ctx) -> Dict:
    """The epoch's rows (on the device) and the three checked batches' row
    indices, all from the seed."""
    from bench_port import dlrm_datagen

    tr = ctx.cell["traffic"]
    b = tr["batch"]
    n = tr["steps_per_epoch"] * b
    rows = dlrm_datagen.batches(ctx.seed, ctx.config, n, ctx.device)
    order = np.random.default_rng([int(ctx.seed), 3]).permutation(n)
    checked = [order[s * b:(s + 1) * b] for s in range(tr["checked_steps"])]
    return {"rows": rows, "checked": checked, "n": n, "steps_per_epoch": tr["steps_per_epoch"]}


def _table0(ctx):
    from bench_port import dlrm_datagen

    return lambda t: dlrm_datagen.initial_table(ctx.seed, ctx.config["model"], t, ctx.device)


def run(ctx) -> Dict:
    import torch
    from recsys_tpu_torch.models import dcn as dcn_mod
    from recsys_tpu_torch.ops import embedding_bag as eb
    from recsys_tpu_torch.train.trainer import Trainer

    from bench_port import compare, dlrm_datagen, tracing
    from bench_port.reference import dlrm as ref_dlrm

    model, tr = ctx.config["model"], ctx.cell["traffic"]
    dev = ctx.device
    b = tr["batch"]
    inp = inputs(ctx)
    data = inp["rows"]
    trainer = Trainer(_config(ctx), output_dir=ctx.tmp, device=dev)
    p0 = dlrm_datagen.weights(ctx.seed, model, dev)
    dense0 = {p: v.clone() for p, v in ref_dlrm.dense_leaves(p0)}
    state = trainer.state_from_params(p0, ctx.seed)
    del p0
    patches = tracing.Patches()
    if ctx.trace:
        patches.wrap(trainer, "_step_core", lambda f: (
            lambda *a, **kw: tracing.spanned("bench.step")(f(*a, **kw))))
        patches.wrap(eb, "bag_forward", tracing.spanned(
            "bench.op.embedding_bag_fwd", lambda table, ids, layout: dict(
                b=ids.shape[0], s=ids.shape[1], t=len(layout.bag_sizes), d=table.shape[1])))
        patches.wrap(eb, "bag_backward_rowwise_adagrad", tracing.spanned(
            "bench.op.sparse_update", lambda table, accum, ids, g, layout, *a, **kw: dict(
                b=ids.shape[0], s=ids.shape[1], t=len(layout.bag_sizes), d=table.shape[1])))
        patches.wrap(dcn_mod, "low_rank_cross_stack", tracing.spanned(
            "bench.op.dcnv2_cross_fwd", lambda params, x0, bf16: dict(
                n=x0.shape[0], f=x0.shape[1], r=params["layer_0"]["v"].shape[1],
                layers=len(params), dtype="bf16" if bf16 else "fp32")))

    # the three checked steps: the trainer's epoch function over one batch each
    check_fn = trainer.make_train_epoch(None, b, 1)
    prog = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for s, idx in enumerate(inp["checked"]):
        ix = torch.as_tensor(idx, device=dev)
        state, m = check_fn(state, {k: v[ix] for k, v in data.items()}, s)
        prog["loss"].append(float(m["loss"]))
        if s == 0:
            accum = state.opt_state["accum"]
            prog["grad_norm"] = ref_dlrm.slot_norms(accum, accum["embedding"]["table"], model)
    prog["change_norm"] = ref_dlrm.change_norms(state.params, dense0, _table0(ctx), model)
    del dense0
    epoch_fn = trainer.make_train_epoch(None, inp["n"], inp["steps_per_epoch"])
    if dev == "cuda":
        torch.cuda.synchronize()

    # the window
    epochs = 0
    with tracing.profiler(ctx.trace) as prof:
        span = None
        if ctx.trace:
            # the profiler's first milliseconds lose records: lead in
            time.sleep(0.2)
            span = tracing.span("bench.window")
            span.__enter__()
        t_start = time.perf_counter()
        marks = [t_start]
        while True:
            state, metrics = epoch_fn(state, data, len(inp["checked"]) + epochs)
            epochs += 1
            marks.append(time.perf_counter())
            if marks[-1] - t_start >= ctx.seconds:
                break
        if dev == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        if span is not None:
            span.__exit__(None, None, None)
    patches.undo()
    trace = tracing.reduce(prof) if prof is not None else None
    counters = {k: float(metrics[k]) for k in ("loss", "lookups", "unique_rows")}
    steps = epochs * inp["steps_per_epoch"]
    elapsed = t_end - t_start
    ctx.log({"window": {"epochs": epochs, "steps": steps, "seconds": elapsed,
                        "epoch_host_s": [b - a for a, b in zip(marks, marks[1:])],
                        "last_epoch": counters, "step_counts": trainer.step_counts}})
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    # the reference, once the program's state is freed
    del state, trainer, epoch_fn, check_fn, metrics
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, inp, "bf16")
    numbers = compare.train_numbers(prog, ref)
    ctx.log({"check": {k: numbers[k] for k in ("worst_grad_leaf", "worst_change_leaf",
                                               "left_out")},
             "reference_s": time.perf_counter() - t_ref,
             "loss": {"program": prog["loss"], "reference": ref["loss"]}})
    ok, checks = compare.judge(numbers, ctx.cell["limits"])
    ok = ok and math.isfinite(counters["loss"])
    return {
        "setup_s": t_start - ctx.t0,
        "e2e": {"setup_s": t_start - ctx.t0, "train_examples_per_s": steps * b / elapsed},
        "attempted": steps, "failed": 0, "correct": ok, "checks": checks,
        "memory_peak_bytes": peak, "trace": trace,
        "stats": {"steps": steps, "examples": steps * b, "window_s": elapsed, "batch": b,
                  "lookups_per_step": counters["lookups"],
                  "unique_rows_per_step": counters["unique_rows"]},
    }


def reference_readings(ctx, inp: Dict, fmt: str, rows_fn=None, fault: str = "") -> Dict:
    """The plain reference's three steps from the same weights and rows
    (``fault``: one of ``reference/dlrm.py``'s planted faults)."""
    import torch

    from bench_port import dlrm_datagen
    from bench_port.reference.dlrm import follow_steps

    params = dlrm_datagen.weights(ctx.seed, ctx.config["model"], ctx.device)
    batches = []
    for idx in inp["checked"]:
        if rows_fn is not None:
            idx = rows_fn(idx)
        ix = torch.as_tensor(np.ascontiguousarray(idx), device=ctx.device)
        batches.append({k: v[ix] for k, v in inp["rows"].items()})
    return follow_steps(params, batches, ctx.config["model"], ctx.config["train"],
                        _table0(ctx), fmt=fmt, rows=ctx.cell["traffic"]["reference_rows"],
                        fault=fault)
