"""The HSTU cell's files: its configuration and cell, its data generator,
its counts against hand counts, its readers on a fake trace with and
without their spans, and whole tiny runs of the cell on the CPU (sound,
broken underneath, and the control and faults that set its limits)."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from bench_port import control_hstu, harness, hstu_datagen, tracing
from bench_port.work import hstu as work
from bench_port.work.peaks import BF16_FLOPS

CELL = "hstu-train-longseq"
CONFIG = "hstu-ml20m-large-l4096"
# the tiny cell: two blocks of one head over d = 64 and ~20-event histories;
# one bf16 rounding that falls the other way moves a leaf of a few thousand
# elements by ~1e-4, where the cell's millions average it out
TINY_LIMITS = {"loss_gap": 2e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


@pytest.fixture
def hstu_root(tiny_root):
    """``tiny_root`` with the HSTU configuration cut to d = 64, 2 blocks of
    one head, N = 80, 50 items, 8 negatives, histories of median 20, and
    its cell to 6 histories a step, 3 steps an epoch."""
    p = os.path.join(tiny_root, "configs", f"{CONFIG}.json")
    with open(p) as f:
        c = json.load(f)
    c["model"].update(embedding_dim=64, hstu_blocks=2, hstu_heads=1, hstu_max_len=80,
                      hstu_items=50, hstu_negatives=8)
    c["data"].update(length_median=20, length_min=1)
    with open(p, "w") as f:
        json.dump(c, f)
    p = os.path.join(tiny_root, "workloads", f"{CELL}.json")
    with open(p) as f:
        w = json.load(f)
    w["traffic"].update(batch=6, steps_per_epoch=3)
    w["limits"] = TINY_LIMITS
    with open(p, "w") as f:
        json.dump(w, f)
    return tiny_root


def _run(root, seed=2**31 + 11, trace=False, seconds=1.0):
    import time

    c = harness.load_cell(CELL, root)
    bench = harness.load_benchmark(os.path.dirname(root))
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), bench, root)


def _config():
    return harness.load_cell(CELL).config


def test_the_config_and_cell_load_and_are_in_the_benchmark():
    cell = harness.load_cell(CELL)
    assert cell.config["name"] == CONFIG and cell.spec["chips"] == 1
    assert cell.spec["traffic"] == {"batch": 128, "steps_per_epoch": 16, "checked_steps": 3}
    bench = harness.load_benchmark()
    entry = [c for c in bench["configs"] if c["name"] == CONFIG][0]
    assert entry["source"] == cell.config["source"] and entry["reduced"] == []
    assert entry["file"] == f"bench_port/configs/{CONFIG}.json"
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")} == {
        "train.device_ms_per_step", "device.idle_share.train", "device.peak_mem_gib.train",
        "hstu_attn_fwd_roofline", "hstu_attn_bwd_roofline", "mfu.train.hstu"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")} == {
        "train_examples_per_s", "setup_s"}
    for other in ("scale-train-cbns", "dlrm-train-mhot"):
        assert not {m["name"] for m in harness.cell_metrics(bench, other, "per_layer")} & {
            "hstu_attn_fwd_roofline", "hstu_attn_bwd_roofline", "mfu.train.hstu"}


@pytest.mark.parametrize("seed", [5, 2**31 + 5, 2**32 + 3])
def test_histories_are_made_by_the_seed_alone_within_their_ranges(seed):
    c = _config()
    a = hstu_datagen.histories(seed, c, 256, "cpu")
    b = hstu_datagen.histories(seed, c, 256, "cpu")
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    lens = a["lengths"]
    assert lens.min() >= 32 and lens.max() <= 4096 and int(lens.sum()) == a["items"].shape[0]
    assert 700 < float(lens.double().median()) < 1400
    assert a["items"].min() >= 1 and a["items"].max() <= c["model"]["hstu_items"]
    ts, start = a["timestamps"], 0
    for n in lens.tolist():
        gaps = ts[start + 1:start + n] - ts[start:start + n - 1]
        assert gaps.min() >= 1 and gaps.max() <= 2_592_000
        start += n
    other = hstu_datagen.histories(seed + 1, c, 256, "cpu")
    assert not torch.equal(other["lengths"], lens)


def test_weights_are_made_by_the_seed_alone_at_the_published_widths():
    m = dict(_config()["model"], hstu_items=1000)
    a, b = hstu_datagen.weights(3, m, "cpu"), hstu_datagen.weights(3, m, "cpu")
    assert torch.equal(a["block_3"]["uvqk"]["w"], b["block_3"]["uvqk"]["w"])
    assert a["block_0"]["uvqk"]["w"].shape == (256, 1024)
    assert a["block_0"]["o"]["w"].shape == (256, 256)
    assert a["block_0"]["pos_w"].shape == (8191,) and a["block_0"]["ts_w"].shape == (129,)
    assert a["item_table"].shape == (1001, 256) and not a["item_table"][0].any()


def test_counts_against_hand_counts():
    m = {"embedding_dim": 8, "hstu_heads": 2, "hstu_blocks": 3, "hstu_negatives": 4}
    # per event and block: 8 x 512 and 128 x 8 products; per pair, block and
    # head two 64-wide products; (1 + 4) logits of 8 a supervised event
    fwd = 3 * (2 * 8 * 512 + 2 * 128 * 8) * 10 + 3 * 2 * (2 * 64) * 2 * 30 + 2 * 8 * 5 * (10 - 4)
    assert work.forward_step(m, events=10, pairs=30, histories=4) == fwd
    assert work.train_step(m, events=10, pairs=30, histories=4) == 3 * fwd
    assert work.hstu_attn_fwd(events=10, pairs=30, heads=2, dqk=64, dv=64) == (
        2 * 30 * 2 * 128, 10 * (2 * 2 * 192 + 8 + 4 * 2 * 64), "bf16")
    assert work.hstu_attn_bwd(events=10, pairs=30, heads=2, dqk=64, dv=64) == (
        4 * 30 * 2 * 128, 10 * (2 * 2 * 256 + 8 + 4 * 2 * 192), "bf16")


def _trace(**ops):
    tr = tracing.Trace()
    tr.window_s, tr.busy_s, tr.n_device_events = 1.0, 0.9, 10
    for name, calls in ops.items():
        tr.op_calls[name].extend(calls)
    return tr


SHAPE = {"events": 184_000, "pairs": 230_000_000, "heads": 4, "dqk": 64, "dv": 64}


@pytest.mark.parametrize("metric,op,count", [
    ("hstu_attn_fwd_roofline", "hstu_attn_fwd", work.hstu_attn_fwd),
    ("hstu_attn_bwd_roofline", "hstu_attn_bwd", work.hstu_attn_bwd)])
def test_attention_rooflines_read_their_spans(metric, op, count):
    reader = harness.load_metric(metric)
    flops, _, _ = count(**SHAPE)
    least = flops / BF16_FLOPS
    res = {"trace": _trace(**{op: [(SHAPE, 4 * least), (SHAPE, 4 * least)]})}
    share, note = reader.read(res, None)
    assert share == pytest.approx(25.0) and "flops" in note and "2 calls" in note
    # no span of it (the parent's program, another cell): nothing to read
    assert reader.read({"trace": _trace()}, None) is None
    assert reader.read({"trace": None}, None) is None


def test_mfu_reads_the_counters_of_the_window():
    reader = harness.load_metric("mfu.train.hstu")
    ctx = SimpleNamespace(config=_config())
    stats = {"steps": 40, "window_s": 10.0, "batch": 128, "events_per_step": 184_000.0,
             "pairs_per_step": 2.3e8}
    per = work.train_step(ctx.config["model"], 184_000.0, 2.3e8, 128)
    assert reader.read({"stats": stats}, ctx) == pytest.approx(100.0 * per * 4 / BF16_FLOPS)
    # a program without the counters, or a cell of another model: nothing
    assert reader.read({"stats": {"steps": 40, "window_s": 10.0, "batch": 128}}, ctx) is None
    assert reader.read({"stats": stats}, SimpleNamespace(config={"model": {}})) is None


def test_a_sound_tiny_run_is_correct_and_traced(hstu_root):
    out = _run(hstu_root, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and "mfu.train.hstu" in out["metrics"]
    out = _run(hstu_root, seed=17)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}


@pytest.mark.parametrize("fault", ["no_time_bias", "half"])
def test_a_broken_step_is_not_correct(hstu_root, monkeypatch, fault):
    from recsys_tpu_torch.ops import hstu_attention as ha
    from recsys_tpu_torch.train.trainer import Trainer

    if fault == "no_time_bias":
        real = ha.hstu_attention
        monkeypatch.setattr(ha, "hstu_attention", lambda v, q, k, pos_w, ts_w, *a, **kw: real(
            v, q, k, pos_w, ts_w * 0, *a, **kw))
    else:
        real_core = Trainer._step_core

        def broken(self, *a, **kw):
            step = real_core(self, *a, **kw)

            def half(state, batch):
                lengths = batch["lengths"][: batch["lengths"].shape[0] // 2]
                e = int(lengths.sum())
                return step(state, {"items": batch["items"][:e],
                                    "timestamps": batch["timestamps"][:e], "lengths": lengths})

            return half

        monkeypatch.setattr(Trainer, "_step_core", broken)
    out = _run(hstu_root)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["keep_rate", "same_masks", "negatives_range",
                                   "negatives_skewed"])
def test_unsound_draws_are_not_correct(hstu_root, monkeypatch, capsys, fault):
    # the reference takes the program's draws as given: a wrong draw would
    # pass its comparison, so the cell's driver checks the draws themselves
    from recsys_tpu_torch.models import hstu as model

    real = model.draw
    gen = torch.Generator().manual_seed(0)

    def planted(*a, **kw):
        out = real(*a, **kw)
        if "input" not in out:  # not a training step
            return out
        if fault == "keep_rate":
            out["input"] = torch.rand(out["input"].shape, generator=gen) < 0.5
        elif fault == "same_masks":
            out["block_1"] = out["block_0"].clone()
        elif fault == "negatives_range":
            out["negatives"] = out["negatives"] - 1
        else:
            items = a[2].hstu_items
            out["negatives"] = (out["negatives"] - 1) % (items // 2) + 1
        return out

    monkeypatch.setattr(model, "draw", planted)
    out = _run(hstu_root)
    assert not out["correct"], out["checks"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    unchecked = [x["unchecked"] for x in lines if "unchecked" in x]
    assert unchecked and unchecked[0]["same_batches"] and unchecked[0]["draws_fault"]


def test_the_control_and_the_planted_faults_fail_the_limits(hstu_root, monkeypatch, capsys):
    monkeypatch.setattr(harness, "HERE", hstu_root)
    real_cell, real_driver = harness.load_cell, harness.load_driver
    monkeypatch.setattr(harness, "load_cell", lambda n, root=hstu_root: real_cell(n, root))
    monkeypatch.setattr(harness, "load_driver", lambda n, root=hstu_root: real_driver(n, root))
    control_hstu.main(["--workload", CELL, "--seeds", "17", "18", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    lines = [x for x in lines if "limits" in x]
    assert len(lines) == 2
    for line in lines:
        limits = line["limits"]
        for reading in [k for k in line if k.startswith(("control", "fault"))]:
            nums = line[reading]
            assert any(nums[n] > lim for n, lim in limits.items()), (reading, nums, limits)
        for sound in ("self", "program"):
            assert all(line[sound][n] <= lim for n, lim in limits.items()), line[sound]
