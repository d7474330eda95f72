"""MLA-MoE training over device-resident jagged histories through
``Trainer.make_train_epoch``.

Set-up: the epoch's histories, made on the card (``mla_moe_datagen.
histories``: their items on the card, their lengths on the host), and the
weights drawn on the card, both from the configuration's ``model_seed``
(the same for every run: the routed load, and with it the step's work,
moves with the weights' and items' draw by ~20%, where the cell's metric
may spread by 0.5%); the run's seed orders the histories into the checked
batches and the epochs and draws the negatives. One ``Trainer``
and one state made by ``Trainer.state_from_params``. That state takes
three checked steps through the trainer's epoch function, one batch each,
on three disjoint batches of histories drawn from the seed (these are the
warm-up too); the trainer records each checked step's batch, its
negatives and each MoE layer's expert choices, which are moved to the
host, and each recorded batch must hold the checked batch's histories (in
the order the epoch took them), or the run is not correct. The program's
readings (each step's loss, the first gradient's norm a leaf from Adam's
first moment, each leaf's change after the third step against the
weights drawn again) are taken as the steps go, so no copy
of the weights is held. Two whole epochs follow, in the set-up: every
step's jagged sizes differ, and the card's memory cache grows to them
there. The run's allocator grows its segments in place (expandable
segments), set at the start of :func:`run` for the process. Then the
window: whole epochs of the same epoch function over every history until
``--seconds`` have passed, ending in a device sync; the step's counters
(events, causal pairs, pairs on held experts, the busiest held expert's
tokens) are read once, after it. Afterwards, with the program's state
freed, the plain reference (``reference/mla_moe.py``) checks the recorded
negatives and expert choices and follows the three checked steps from the
same weights, histories and draws.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np

WARM_EPOCHS = 2  # whole epochs in the set-up, before the window
B1 = 0.9         # Adam's first beta: the first moment after step 1 is (1 - B1) g
# at most this share of the checked tokens over the three steps may take
# other experts than the reference's own top-k (only ties at the first
# step, ``reference/mla_moe.py::TIE``): the cell's runs read 3.1-3.2%
MAX_DIFFER_SHARE = 5e-2


def _config(ctx):
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig

    cfg, tr = ctx.config, ctx.cell["traffic"]
    t = cfg["train"]
    train = TrainConfig(batch_size=tr["batch"], optimizer=t["optimizer"],
                        learning_rate=t["learning_rate"], lr_decay_rate=t["lr_decay_rate"],
                        clipnorm=t["clipnorm"], warmup_steps=t.get("warmup_steps", 0),
                        seed=int(ctx.seed) % (1 << 31), async_checkpoint=False)
    return RecsysConfig(model=ModelConfig(**cfg["model"]), train=train)


def weights(ctx) -> Dict:
    """The initial weights, drawn from the configuration's model seed."""
    from bench_port import mla_moe_datagen

    return mla_moe_datagen.weights(ctx.config["data"]["model_seed"], ctx.config["model"],
                                   ctx.device)


def inputs(ctx) -> Dict:
    """The epoch's histories (items on the device, lengths on the host),
    drawn from the configuration's model seed, and the three checked
    batches' history indices, from the run's seed."""
    from bench_port import mla_moe_datagen

    tr = ctx.cell["traffic"]
    b = tr["batch"]
    n = tr["steps_per_epoch"] * b
    data = mla_moe_datagen.histories(ctx.config["data"]["model_seed"], ctx.config, n,
                                     ctx.device)
    order = np.random.default_rng([int(ctx.seed) % (1 << 63), 3]).permutation(n)
    checked = [np.sort(order[s * b:(s + 1) * b]) for s in range(tr["checked_steps"])]
    return {"data": data, "checked": checked, "n": n, "steps_per_epoch": tr["steps_per_epoch"]}


def subset(data: Dict, idx) -> Dict:
    """The histories ``idx`` of a jagged split, in that order."""
    import torch

    lengths = data["lengths"]
    starts = torch.zeros_like(lengths)
    starts[1:] = torch.cumsum(lengths, 0)[:-1]
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    rows = torch.cat([torch.arange(int(starts[i]), int(starts[i] + lengths[i])) for i in idx])
    return {"items": data["items"][rows.to(data["items"].device)],
            "lengths": lengths[idx].clone()}


def _host(step: Dict) -> Dict:
    return {"items": step["items"].cpu(), "lengths": step["lengths"].cpu(),
            "draws": {k: v.cpu() for k, v in step["draws"].items()},
            "experts": {k: v.cpu() for k, v in step["experts"].items()}}


def _histories(step: Dict) -> List[bytes]:
    """A batch's histories as sorted byte strings."""
    items = step["items"].cpu().numpy()
    out, start = [], 0
    for n in step["lengths"].tolist():
        out.append(items[start:start + n].tobytes())
        start += n
    return sorted(out)


def _norms(tree) -> Dict[str, float]:
    import torch

    from bench_port.reference.hstu import leaves

    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in leaves(tree).items()}


def checked_steps(ctx, inp: Dict, trainer, state):
    """The three checked steps through the trainer's epoch function ->
    (state, the program's readings, the recorded steps on the host). Each
    recorded step (whose draws and choices the reference is given) must
    hold the checked batch's histories, each unchanged."""
    import torch

    from bench_port.reference.hstu import change_norms

    b = ctx.cell["traffic"]["batch"]
    check_fn = trainer.make_train_epoch(None, b, 1)
    losses, grad_norm, recorded = [], {}, []
    same = True
    for s, idx in enumerate(inp["checked"]):
        trainer.record_steps = []
        batch = subset(inp["data"], idx)
        state, m = check_fn(state, batch, s)
        losses.append(float(m["loss"]))
        steps = [_host(step) for step in trainer.record_steps]
        same = same and len(steps) == 1 and _histories(steps[0]) == _histories(batch)
        recorded.extend(steps)
        if s == 0:
            grad_norm = {k: v / (1 - B1) for k, v in _norms(state.opt_state["mu"]).items()}
    trainer.record_steps = None
    p0 = weights(ctx)
    prog = {"loss": losses, "grad_norm": grad_norm,
            "change_norm": change_norms(state.params, p0), "same_batches": same}
    del p0
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return state, prog, recorded


def _spanned_backward(fn, op: str, shape_of):
    from bench_port import tracing

    def backward(ctx, *g):
        with tracing.span(tracing.span_name(f"bench.op.{op}", **shape_of(ctx))):
            return fn(ctx, *g)

    return backward


def _moe_shape(d, width, direction):
    # the pairs on held experts stay on the device (the step has no host
    # sync): the reader takes them from the step's counter
    return dict(d=d, width=width, direction=direction)


def install_spans(patches, trainer) -> None:
    """The traced run's spans: each step, each call of rows 14 and 15, and
    each call of the routed experts (row 16's products with their gathers,
    transposes, SwiGLU and combine; the backward's recomputed forward) in
    either direction."""
    from recsys_tpu_torch.ops import mla_attention as ma
    from recsys_tpu_torch.ops import moe

    from bench_port import tracing

    patches.wrap(trainer, "_step_core", lambda f: (
        lambda *a, **kw: tracing.spanned("bench.step")(f(*a, **kw))))
    patches.wrap(ma, "mla_attention", tracing.spanned(
        "bench.op.mla_attn_fwd", lambda q, k, v, layout, heads, *a, **kw: dict(
            events=layout.events, pairs=layout.pairs, heads=heads, dqk=q.shape[1] // heads,
            dv=v.shape[1] // heads)))
    patches.wrap(ma.MlaAttention, "backward", lambda fn: _spanned_backward(
        fn, "mla_attn_bwd", lambda c: dict(events=c.layout.events, pairs=c.layout.pairs,
                                           heads=c.heads, dqk=ma.DQK, dv=ma.DV)))
    patches.wrap(moe.RoutedExperts, "forward", lambda fn: (
        lambda ctx, x, gates, w_gate_up, w_down, disp: _call_spanned(
            fn, _moe_shape(x.shape[1], w_down.shape[1], "fwd"), ctx, x, gates, w_gate_up,
            w_down, disp)))
    patches.wrap(moe.RoutedExperts, "backward", lambda fn: _spanned_backward(
        fn, "moe_experts", lambda c: _moe_shape(c.saved_tensors[0].shape[1],
                                                c.saved_tensors[3].shape[1], "bwd")))


def _call_spanned(fn, shape, *args):
    from bench_port import tracing

    with tracing.span(tracing.span_name("bench.op.moe_experts", **shape)):
        return fn(*args)


def run(ctx) -> Dict:
    import torch
    from recsys_tpu_torch.train.trainer import Trainer

    from bench_port import compare, tracing

    tr = ctx.cell["traffic"]
    dev = ctx.device
    b = tr["batch"]
    if dev == "cuda":
        # the process's allocator policy (as the train CLI sets it at its
        # start): the harness has started CUDA by now, so set at run time
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    trainer = Trainer(_config(ctx), output_dir=ctx.tmp, device=dev)
    inp = inputs(ctx)
    state = trainer.state_from_params(weights(ctx), ctx.seed)
    patches = tracing.Patches()
    if ctx.trace:
        install_spans(patches, trainer)

    state, prog, recorded = checked_steps(ctx, inp, trainer, state)
    epoch_fn = trainer.make_train_epoch(None, inp["n"], inp["steps_per_epoch"])
    first = len(inp["checked"]) + WARM_EPOCHS
    for e in range(len(inp["checked"]), first):
        state, _ = epoch_fn(state, inp["data"], e)
    if dev == "cuda":
        torch.cuda.synchronize()

    # the window; the cyclic garbage collector's passes and the allocator's
    # retries in it are logged beside its epochs
    epochs = 0
    gc_s: List[float] = []
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s.append(time.perf_counter() - gc_t0[0])

    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0) if dev == "cuda" else 0
    gc.callbacks.append(on_gc)
    with tracing.profiler(ctx.trace) as prof:
        span = None
        if ctx.trace:
            time.sleep(0.2)  # the profiler's first milliseconds lose records: lead in
            span = tracing.span("bench.window")
            span.__enter__()
        t_start = time.perf_counter()
        marks = [t_start]
        while True:
            state, metrics = epoch_fn(state, inp["data"], first + epochs)
            epochs += 1
            marks.append(time.perf_counter())
            if marks[-1] - t_start >= ctx.seconds:
                break
        if dev == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        if span is not None:
            span.__exit__(None, None, None)
    gc.callbacks.remove(on_gc)
    patches.undo()
    trace = tracing.reduce(prof) if prof is not None else None
    counters = {k: float(metrics[k]) for k in ("loss", "balance_loss", "events", "attn_pairs",
                                               "moe_assignments", "moe_max_expert_tokens")}
    steps = epochs * inp["steps_per_epoch"]
    elapsed = t_end - t_start
    ctx.log({"window": {"epochs": epochs, "steps": steps, "seconds": elapsed,
                        "epoch_host_s": [y - x for x, y in zip(marks, marks[1:])],
                        "gc_passes": len(gc_s), "gc_s": sum(gc_s),
                        "alloc_retries": (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                                          - retries0) if dev == "cuda" else 0,
                        "reserved_peak_gib": (torch.cuda.max_memory_reserved() / 2**30
                                              if dev == "cuda" else 0.0),
                        "last_epoch": counters}})
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    # the reference, once the program's state is freed
    del state, trainer, epoch_fn, metrics
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    check = {"fault": "", "differ": [], "tokens": []}
    if prog["same_batches"]:
        ref = reference_readings(ctx, recorded, "bf16", check=check)
    else:
        check["fault"] = "other histories than the checked batches'"
        ref = {}
    differ_share = sum(check["differ"]) / max(sum(check["tokens"]), 1)
    if check["fault"] or differ_share > MAX_DIFFER_SHARE:
        ctx.log({"unchecked": check, "differ_share": differ_share})
        numbers = {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                   "worst_grad_leaf": "", "worst_change_leaf": "", "left_out": []}
        ref = {"loss": []}
    else:
        numbers = compare.train_numbers(prog, ref)
    ctx.log({"check": {k: numbers[k] for k in ("worst_grad_leaf", "worst_change_leaf",
                                               "left_out")},
             "expert_choices": {"differ": check["differ"], "tokens": check["tokens"],
                                "differ_share": differ_share,
                                "ties_first_step": check.get("ties", 0),
                                "worst_shortfall": check.get("worst_shortfall", 0.0)},
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
                  "events_per_step": counters["events"],
                  "pairs_per_step": counters["attn_pairs"],
                  "assignments_per_step": counters["moe_assignments"],
                  "max_expert_tokens": counters["moe_max_expert_tokens"]},
    }


def halve(step: Dict) -> Dict:
    """A recorded step cut to its first half of histories (and their rows
    of the draws and choices)."""
    lengths = step["lengths"]
    h = lengths.shape[0] // 2
    e = int(lengths[:h].sum())
    return {"items": step["items"][:e], "lengths": lengths[:h],
            "draws": {k: v[:e - h] for k, v in step["draws"].items()},
            "experts": {k: v[:e] for k, v in step["experts"].items()}}


def reference_readings(ctx, recorded: List[Dict], fmt: str, fault: str = "",
                       half: bool = False, check=None) -> Dict:
    """The plain reference's steps from the same weights over the recorded
    steps (``fault``: one of ``reference/mla_moe.py``'s planted faults;
    ``half``: each batch's first half of histories only; ``check``: the
    draws and choices held first, see ``follow_steps``)."""
    from bench_port.reference.mla_moe import follow_steps

    params = weights(ctx)
    steps = [halve(s) for s in recorded] if half else recorded
    return follow_steps(params, steps, ctx.config["model"], ctx.config["train"], fmt=fmt,
                        fault=fault, check=check)
