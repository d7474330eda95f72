"""HSTU training over device-resident jagged histories through
``Trainer.make_train_epoch``.

Set-up: the epoch's histories from the seed, made on the card
(``hstu_datagen.histories``: their events on the card, their lengths on
the host), the weights drawn on the card from the seed, one ``Trainer``
and one state made by ``Trainer.state_from_params``. That state takes
three checked steps through the trainer's epoch function, one batch each,
on three disjoint batches of histories drawn from the seed (these are the
warm-up too); the trainer records each checked step's batch and draws
(dropout masks and negatives), which are moved to the host, and each
recorded batch must hold the checked batch's histories (in the order the
epoch took them), and its draws must be sound (``draws_fault``: keep
shares, distinct masks, negatives in range and near uniform), or the run
is not correct. Two whole epochs follow, in the set-up: every step's
jagged sizes differ, and the card's memory cache grows to them there (the
first runs 1.5-13% slower than the next; with one alone, one run in six
lost 0.75 s in the window's first epoch). The run's allocator grows its
segments in place (expandable segments), set at the start of :func:`run`
for the process: jagged sizes keep asking for new blocks, and each new
``cudaMalloc`` stalls the card mid-step. Then the window: whole epochs
of the same epoch function over every history until ``--seconds`` have
passed, ending in a device sync; the step's counters
(events and causal pairs a step) are read once, after it. Afterwards,
with the program's state freed, the plain reference
(``reference/hstu.py``) follows the three checked steps from the same
weights, histories and draws.
"""

from __future__ import annotations

import copy
import gc
import math
import time
from typing import Dict, List

import numpy as np

WARM_EPOCHS = 2  # whole epochs in the set-up, before the window


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
    """The epoch's histories (events on the device, lengths on the host)
    and the three checked batches' history indices, all from the seed."""
    from bench_port import hstu_datagen

    tr = ctx.cell["traffic"]
    b = tr["batch"]
    n = tr["steps_per_epoch"] * b
    data = hstu_datagen.histories(ctx.seed, ctx.config, n, ctx.device)
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
    rows = rows.to(data["items"].device)
    return {"items": data["items"][rows], "timestamps": data["timestamps"][rows],
            "lengths": lengths[idx].clone()}


def _host(step: Dict) -> Dict:
    """A recorded step with its tensors on the host."""
    return {"items": step["items"].cpu(), "timestamps": step["timestamps"].cpu(),
            "lengths": step["lengths"].cpu(),
            "draws": {k: v.cpu() for k, v in step["draws"].items()}}


def _histories(step: Dict) -> List[bytes]:
    """A batch's histories (ids and timestamps) as sorted byte strings."""
    items, ts = step["items"].cpu().numpy(), step["timestamps"].cpu().numpy()
    out, start = [], 0
    for n in step["lengths"].tolist():
        out.append(items[start:start + n].tobytes() + ts[start:start + n].tobytes())
        start += n
    return sorted(out)


# how far a draw's statistic may stray, in standard deviations (a sound
# run passes each with a chance of about 1 - 1e-9)
DRAW_SIGMAS = 8.0
# equal-width bins of the item ids for the negatives' histogram
DRAW_BINS = 64


def draws_fault(step: Dict, model: Dict) -> str:
    """What is wrong with a recorded step's draws (its dropout keep-masks
    and negatives, which the reference takes as given), or "": each mask
    keeps a share within ``DRAW_SIGMAS`` binomial deviations of 1 -
    ``dropout_rate``, no two masks are equal, and the negatives lie in
    1..hstu_items with a histogram over ``DRAW_BINS`` bins of ids whose
    chi-square lies within ``DRAW_SIGMAS`` deviations of its mean under
    uniform draws."""
    import torch

    draws = step["draws"]
    keep = 1.0 - model["dropout_rate"]
    masks = [(k, v) for k, v in draws.items() if k != "negatives"]
    for name, mask in masks:
        n = mask.numel()
        share = float(mask.sum()) / n if n else keep
        if abs(share - keep) > DRAW_SIGMAS * math.sqrt(keep * (1 - keep) / max(n, 1)):
            return f"mask {name} keeps {share:.6f} of {n}, want {keep}"
    for i, (a, x) in enumerate(masks):
        for b, y in masks[i + 1:]:
            if x.shape == y.shape and torch.equal(x, y):
                return f"masks {a} and {b} are equal"
    neg, items = draws["negatives"].reshape(-1).long(), model["hstu_items"]
    if neg.numel() == 0:
        return ""
    if int(neg.min()) < 1 or int(neg.max()) > items:
        return f"negatives in [{int(neg.min())}, {int(neg.max())}], want [1, {items}]"
    bins = min(DRAW_BINS, items)
    width = torch.bincount(torch.arange(items) * bins // items, minlength=bins).double()
    want = neg.numel() * width / items
    got = torch.bincount((neg - 1) * bins // items, minlength=bins).double()
    chi2 = float(torch.sum((got - want) ** 2 / want))
    z = (chi2 - (bins - 1)) / math.sqrt(2 * max(bins - 1, 1))
    if z > DRAW_SIGMAS:
        return f"negatives' histogram off uniform: chi-square {chi2:.1f} over {bins} bins"
    return ""


def checked_steps(ctx, inp: Dict, trainer, state):
    """The three checked steps through the trainer's epoch function ->
    (state, the program's readings, the recorded steps on the host). The
    epoch function may take a batch's histories in any order: each
    recorded step (whose draws the reference is given) must hold the
    checked batch's histories, each unchanged, and draws that pass
    :func:`draws_fault`, or its readings read ``inf``."""
    import torch

    from bench_port.reference import hstu as ref_hstu

    b = ctx.cell["traffic"]["batch"]
    check_fn = trainer.make_train_epoch(None, b, 1)
    losses, mu1, recorded = [], None, []
    p0 = {k: v.detach().clone() for k, v in ref_hstu.leaves(state.params).items()}
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
            mu1 = copy.deepcopy(state.opt_state["mu"])
    trainer.record_steps = None
    prog = ref_hstu.program_readings(losses, mu1, state.params, _tree(p0))
    prog["same_batches"] = same
    prog["draws_fault"] = next((f for f in (draws_fault(r, ctx.config["model"])
                                            for r in recorded) if f), "")
    del mu1, p0
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return state, prog, recorded


def _tree(flat: Dict) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _spanned_backward(fn):
    from bench_port import tracing

    def backward(ctx, g):
        qkv = ctx.saved_tensors[0]
        name = tracing.span_name("bench.op.hstu_attn_bwd", events=ctx.layout.events,
                                 pairs=ctx.layout.pairs, heads=qkv.shape[1] // 192, dqk=64,
                                 dv=64)
        with tracing.span(name):
            return fn(ctx, g)

    return backward


def run(ctx) -> Dict:
    import torch
    from recsys_tpu_torch.ops import hstu_attention as ha
    from recsys_tpu_torch.train.trainer import Trainer

    from bench_port import compare, hstu_datagen, tracing

    model, tr = ctx.config["model"], ctx.cell["traffic"]
    dev = ctx.device
    b = tr["batch"]
    if dev == "cuda":
        # the process's allocator policy (as the train CLI sets it at its
        # start): the harness has started CUDA by now, so set at run time
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    trainer = Trainer(_config(ctx), output_dir=ctx.tmp, device=dev)
    inp = inputs(ctx)
    state = trainer.state_from_params(hstu_datagen.weights(ctx.seed, model, dev), ctx.seed)
    patches = tracing.Patches()
    if ctx.trace:
        patches.wrap(trainer, "_step_core", lambda f: (
            lambda *a, **kw: tracing.spanned("bench.step")(f(*a, **kw))))
        patches.wrap(ha, "hstu_attention", tracing.spanned(
            "bench.op.hstu_attn_fwd", lambda v, q, k, pos_w, ts_w, ts, layout, *a, **kw: dict(
                events=layout.events, pairs=layout.pairs, heads=q.shape[1] // 64, dqk=64,
                dv=64)))
        patches.wrap(ha.HstuAttention, "backward", _spanned_backward)

    state, prog, recorded = checked_steps(ctx, inp, trainer, state)
    epoch_fn = trainer.make_train_epoch(None, inp["n"], inp["steps_per_epoch"])
    # whole epochs before the window: every step's jagged sizes differ,
    # and the card's memory cache grows to them here, in the set-up
    first = len(inp["checked"]) + WARM_EPOCHS
    for e in range(len(inp["checked"]), first):
        state, _ = epoch_fn(state, inp["data"], e)
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
    patches.undo()
    trace = tracing.reduce(prof) if prof is not None else None
    counters = {k: float(metrics[k]) for k in ("loss", "events", "attn_pairs")}
    steps = epochs * inp["steps_per_epoch"]
    elapsed = t_end - t_start
    ctx.log({"window": {"epochs": epochs, "steps": steps, "seconds": elapsed,
                        "epoch_host_s": [y - x for x, y in zip(marks, marks[1:])],
                        "last_epoch": counters, "step_counts": trainer.step_counts}})
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    # the reference, once the program's state is freed
    del state, trainer, epoch_fn, metrics
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if prog["same_batches"] and not prog["draws_fault"]:
        ref = reference_readings(ctx, recorded, "bf16")
        numbers = compare.train_numbers(prog, ref)
    else:  # other histories than the checked batches', or unsound draws
        ctx.log({"unchecked": {"same_batches": prog["same_batches"],
                               "draws_fault": prog["draws_fault"]}})
        ref = {"loss": []}
        numbers = {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                   "worst_grad_leaf": "", "worst_change_leaf": "", "left_out": []}
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
                  "events_per_step": counters["events"],
                  "pairs_per_step": counters["attn_pairs"]},
    }


def halve(step: Dict) -> Dict:
    """A recorded step cut to its first half of histories (and their
    draws' rows)."""
    lengths = step["lengths"]
    h = lengths.shape[0] // 2
    e = int(lengths[:h].sum())
    draws = {k: (v[:e - h] if k == "negatives" else v[:e]) for k, v in step["draws"].items()}
    return {"items": step["items"][:e], "timestamps": step["timestamps"][:e],
            "lengths": lengths[:h], "draws": draws}


def reference_readings(ctx, recorded: List[Dict], fmt: str, fault: str = "",
                       half: bool = False) -> Dict:
    """The plain reference's steps from the same weights over the recorded
    steps (``fault``: one of ``reference/hstu.py``'s planted faults;
    ``half``: each batch's first half of histories only)."""
    from bench_port import hstu_datagen
    from bench_port.reference.hstu import follow_steps

    params = hstu_datagen.weights(ctx.seed, ctx.config["model"], ctx.device)
    steps = [halve(s) for s in recorded] if half else recorded
    return follow_steps(params, steps, ctx.config["model"], ctx.config["train"], fmt=fmt,
                        fault=fault)
