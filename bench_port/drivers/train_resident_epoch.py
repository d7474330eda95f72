"""Training over device-resident data through ``Trainer.make_train_epoch``.

Set-up: the training rows from the seed (on the host, then on the card),
the class weights and the logQ column, weights drawn on the card from the
seed with ``item_bias`` at the log train frequency, one ``Trainer`` and
one state made by ``Trainer.state_from_params``. That state takes three
checked steps through the trainer's epoch function, one batch each, on
three disjoint batches of rows drawn from the seed (these are the
warm-up too), and then the window: whole epochs of the same epoch
function over every training row until ``--seconds`` have passed, ending
in a device sync. Afterwards the plain reference follows the three
checked steps from the same weights and rows.
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
    train = TrainConfig(batch_size=tr["batch"], negative_cache=tr.get("negative_cache", 0),
                        sparse_table_updates=tr.get("sparse_table_updates", "auto"),
                        optimizer=t["optimizer"], learning_rate=t["learning_rate"],
                        learning_rate_ranking=t["learning_rate_ranking"],
                        clipnorm=t["clipnorm"], use_class_weights=t["use_class_weights"],
                        logq_correction=t["logq_correction"], seed=int(ctx.seed) % (1 << 31),
                        async_checkpoint=False)
    return RecsysConfig(model=ModelConfig(**cfg["model"]), train=train)


def inputs(ctx) -> Dict:
    """The rows, class weights, logQ table and the three checked batches'
    row indices, all from the seed."""
    from bench_port import datagen

    cfg, tr = ctx.config, ctx.cell["traffic"]
    b = tr["batch"]
    rows = datagen.train_split(ctx.seed, cfg["data"], b)
    log_q = datagen.log_q_table(rows["movie_id"], cfg["data"]["n_items"])
    rows["log_q"] = log_q[rows["movie_id"]]
    n = len(rows["user_id"])
    order = np.random.default_rng([int(ctx.seed), 3]).permutation(n)
    checked = [order[s * b:(s + 1) * b] for s in range(tr["checked_steps"])]
    return {"rows": rows, "log_q": log_q, "cw": datagen.class_weights(rows["y_implicit"]),
            "checked": checked, "n": n, "steps_per_epoch": n // b}


def run(ctx) -> Dict:
    import torch
    from recsys_tpu_torch.ops import flash_ce as flash_mod
    from recsys_tpu_torch.train.trainer import Trainer

    from bench_port import compare, datagen, tracing
    from bench_port.reference.model import change_norms, slot_norms

    cfg, tr = ctx.config, ctx.cell["traffic"]
    dev = ctx.device
    nu, ni = cfg["data"]["n_users"], cfg["data"]["n_items"]
    b = tr["batch"]
    inp = inputs(ctx)
    data = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev) for k, v in inp["rows"].items()}
    trainer = Trainer(_config(ctx), output_dir=ctx.tmp, device=dev)
    p0 = datagen.weights(ctx.seed, cfg["model"], nu, ni, dev, item_bias=inp["log_q"])
    state = trainer.state_from_params(p0, ctx.seed)
    patches = tracing.Patches()
    if ctx.trace:
        patches.wrap(trainer, "_step_core", lambda f: (
            lambda *a, **kw: tracing.spanned("bench.step")(f(*a, **kw))))
        patches.wrap(flash_mod, "flash_softmax_ce", tracing.spanned(
            "bench.op.flash_ce_fwd", lambda u, v, *a: dict(
                bq=u.shape[0], bk=v.shape[0], d=u.shape[1],
                dtype="bf16" if u.dtype == torch.bfloat16 else "fp32")))
        patches.wrap(flash_mod.FlashSoftmaxCE, "backward", _spanned_backward)

    # the three checked steps: the trainer's epoch function over one batch each
    check_fn = trainer.make_train_epoch(inp["cw"], b, 1)
    prog = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for s, idx in enumerate(inp["checked"]):
        ix = torch.as_tensor(idx, device=dev)
        state, m = check_fn(state, {k: v[ix] for k, v in data.items()}, s)
        prog["loss"].append(float(m["loss"]))
        if s == 0:
            # the norms as the optimizer's slot holds them, read by the
            # benchmark's arithmetic (the same as for the reference's slot)
            prog["grad_norm"] = slot_norms(state.opt_state["accum"])
    prog["change_norm"] = change_norms(state.params, p0)
    del p0
    epoch_fn = trainer.make_train_epoch(inp["cw"], inp["n"], inp["steps_per_epoch"])
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
    window_loss = float(metrics["loss"])
    steps = epochs * inp["steps_per_epoch"]
    elapsed = t_end - t_start
    ctx.log({"window": {"epochs": epochs, "steps": steps, "seconds": elapsed,
                        "epoch_host_s": [b - a for a, b in zip(marks, marks[1:])],
                        "last_epoch_loss": window_loss, "step_counts": trainer.step_counts}})
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    # the reference, once the program's state is freed
    del state, trainer, data, epoch_fn, check_fn, metrics
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
    ok = ok and math.isfinite(window_loss)
    return {
        "setup_s": t_start - ctx.t0,
        "e2e": {"setup_s": t_start - ctx.t0, "train_examples_per_s": steps * b / elapsed},
        "attempted": steps, "failed": 0, "correct": ok, "checks": checks,
        "memory_peak_bytes": peak, "trace": trace,
        "stats": {"steps": steps, "examples": steps * b, "window_s": elapsed,
                  "batch": b, "n_candidates": b + tr.get("negative_cache", 0)},
    }


def reference_readings(ctx, inp: Dict, fmt: str, rows_fn=None) -> Dict:
    """The plain reference's three steps from the same weights and rows."""
    import torch

    from bench_port import datagen
    from bench_port.reference.model import follow_steps

    cfg, tr = ctx.config, ctx.cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = ctx.device
    nu, ni = cfg["data"]["n_users"], cfg["data"]["n_items"]
    params = datagen.weights(ctx.seed, cfg["model"], nu, ni, dev, item_bias=inp["log_q"])
    batches = []
    for idx in inp["checked"]:
        if rows_fn is not None:
            idx = rows_fn(idx)
        batches.append({k: torch.as_tensor(np.ascontiguousarray(v[idx])).to(dev)
                        for k, v in inp["rows"].items()})
    train = dict(cfg["train"], cw=inp["cw"])
    return follow_steps(params, batches, cfg["model"], train, tr.get("negative_cache", 0),
                        fmt=fmt, rows=tr.get("reference_rows", 4096))


def _spanned_backward(fn):
    from bench_port import tracing

    def backward(ctx, g):
        u, v = ctx.saved_tensors[:2]
        import torch

        name = tracing.span_name("bench.op.flash_ce_bwd", bq=u.shape[0], bk=v.shape[0],
                                 d=u.shape[1],
                                 dtype="bf16" if u.dtype == torch.bfloat16 else "fp32")
        with tracing.span(name):
            return fn(ctx, g)

    return backward
