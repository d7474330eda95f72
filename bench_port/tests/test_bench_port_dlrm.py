"""The DLRM-DCNv2 cell's files: its readers on a fake trace with and
without their spans, its counts against hand counts, and whole tiny runs
of the cell on the CPU (sound, broken underneath, and the control and
faults that set its limits)."""

import json
import os
from types import SimpleNamespace

import pytest

from bench_port import control_dlrm, harness, tracing
from bench_port.work import dlrm as work
from bench_port.work.peaks import BF16_FLOPS, HBM_BYTES_PER_S

CELL = "dlrm-train-mhot"
# the tiny cell: a few hundred elements a leaf, so one bf16 rounding that
# falls the other way moves a leaf's norm by ~1e-4 where the cell's
# millions average it out; the control reads ~1e-3 / 4e-2 / 1.5e-2 here
TINY_LIMITS = {"loss_gap": 2e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


@pytest.fixture
def dlrm_root(tiny_root):
    """``tiny_root`` with the DLRM configuration cut to 5 tables of 3 to
    2,000 rows, D = 16, and its cell to B = 64."""
    p = os.path.join(tiny_root, "configs", "mlperf-dlrm-dcnv2-1of8.json")
    with open(p) as f:
        c = json.load(f)
    rows = [3, 50, 2000, 7, 311]
    c["model"].update(embedding_dim=16, table_rows=rows, bag_sizes=[1, 3, 7, 2, 5],
                      table_init_rows=rows, bottom_mlp_dims=[32, 16], over_arch_dims=[32, 16],
                      dcn_low_rank_dim=8, cross_layers=2)
    with open(p, "w") as f:
        json.dump(c, f)
    p = os.path.join(tiny_root, "workloads", f"{CELL}.json")
    with open(p) as f:
        w = json.load(f)
    w["traffic"].update(batch=64, steps_per_epoch=4, reference_rows=24)
    w["limits"] = TINY_LIMITS
    with open(p, "w") as f:
        json.dump(w, f)
    return tiny_root


def _run(root, seed=2**31 + 11, trace=False, seconds=1.0):
    import time

    c = harness.load_cell(CELL, root)
    bench = harness.load_benchmark(os.path.dirname(root))
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), bench, root)


def _ctx():
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "mlperf-dlrm-dcnv2-1of8.json")) as f:
        return SimpleNamespace(config=json.load(f))


def test_counts_against_hand_counts():
    m = {"table_rows": [5, 6], "embedding_dim": 4, "dlrm_dense_in": 3,
         "bottom_mlp_dims": [8, 4], "cross_layers": 2, "dcn_low_rank_dim": 2,
         "over_arch_dims": [5]}
    # F = 3 x 4 = 12: bottom 3->8->4, two cross layers of 12->2->12, over 12->5->1
    fwd = 2 * (3 * 8 + 8 * 4) + 2 * 2 * (2 * 12 * 2) + 2 * (12 * 5 + 5 * 1)
    assert work.forward_example(m) == fwd and work.train_example(m) == 3 * fwd
    assert work.embedding_bag_fwd(b=2, s=5, t=2, d=4, unique_rows=7) == (
        2 * 3 * 4, 4 * 7 * 4 + 4 * 2 * 5 + 4 * 2 * 2 * 4, "fp32")
    assert work.sparse_update(b=2, s=5, t=2, d=4, unique_rows=7) == (
        2 * 5 * 4 + 4 * 7 * 4, 4 * 2 * 2 * 4 + 4 * 2 * 5 + 2 * 7 * (4 * 4 + 4), "fp32")
    assert work.dcnv2_cross_fwd(n=3, f=12, r=2, layers=2, dtype="bf16") == (
        2 * (4 * 3 * 12 * 2 + 3 * 3 * 12), 4 * (2 * 3 * 12 + 2 * (2 * 12 * 2 + 12)), "bf16")


def test_the_published_model_trains_96_mflop_an_example():
    assert work.forward_example(_ctx().config["model"]) == 32_060_928


def _trace(**ops):
    tr = tracing.Trace()
    tr.window_s, tr.busy_s, tr.n_device_events = 1.0, 0.9, 10
    for name, calls in ops.items():
        tr.op_calls[name].extend(calls)
    return tr


SHAPE = {"b": 65536, "s": 214, "t": 26, "d": 128}


@pytest.mark.parametrize("metric,op,count", [
    ("embedding_bag_fwd_roofline", "embedding_bag_fwd", work.embedding_bag_fwd),
    ("sparse_update_roofline", "sparse_update", work.sparse_update)])
def test_bag_rooflines_read_the_counter_and_their_spans(metric, op, count):
    reader = harness.load_metric(metric)
    u = 7.5e6
    _, n_bytes, _ = count(**SHAPE, unique_rows=u)
    least = n_bytes / HBM_BYTES_PER_S
    res = {"trace": _trace(**{op: [(SHAPE, 4 * least), (SHAPE, 4 * least)]}),
           "stats": {"unique_rows_per_step": u}}
    share, note = reader.read(res, None)
    assert share == pytest.approx(25.0) and "bytes" in note and "2 calls" in note
    # no span of it in the trace, or no counter in the program: nothing to read
    assert reader.read({"trace": _trace(), "stats": {"unique_rows_per_step": u}}, None) is None
    assert reader.read({"trace": res["trace"], "stats": {}}, None) is None
    assert reader.read({"trace": None, "stats": {}}, None) is None


def test_cross_roofline_is_bound_by_its_products():
    reader = harness.load_metric("dcnv2_cross_fwd_roofline")
    shape = {"n": 65536, "f": 3456, "r": 512, "layers": 3, "dtype": "bf16"}
    flops, _, _ = work.dcnv2_cross_fwd(**shape)
    share, note = reader.read({"trace": _trace(dcnv2_cross_fwd=[(shape, 2 * flops / BF16_FLOPS)])},
                              None)
    assert share == pytest.approx(50.0) and "flops" in note
    assert reader.read({"trace": _trace()}, None) is None


def test_mfu_reads_the_examples_of_the_window():
    reader = harness.load_metric("mfu.train.dlrm")
    ctx = _ctx()
    per = work.train_example(ctx.config["model"])
    res = {"stats": {"examples": 1_000_000, "window_s": 2.0}}
    assert reader.read(res, ctx) == pytest.approx(100.0 * per * 5e5 / BF16_FLOPS)
    # a cell of another model has nothing for it to read
    assert reader.read(res, SimpleNamespace(config={"model": {"embedding_dim": 128}})) is None


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    bench = harness.load_benchmark()
    assert CELL in [w["name"] for w in bench["workloads"]]
    per_layer = {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")}
    assert per_layer == {"train.device_ms_per_step", "device.idle_share.train",
                         "device.peak_mem_gib.train", "mfu.train.dlrm",
                         "embedding_bag_fwd_roofline", "sparse_update_roofline",
                         "dcnv2_cross_fwd_roofline"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")} == {
        "train_examples_per_s", "setup_s"}


def test_a_sound_tiny_run_is_correct_and_traced(dlrm_root):
    out = _run(dlrm_root, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and "mfu.train.dlrm" in out["metrics"]
    out = _run(dlrm_root, seed=17)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "mean_bags"])
def test_a_broken_step_is_not_correct(dlrm_root, monkeypatch, fault):
    import torch
    from recsys_tpu_torch.ops import embedding_bag as eb
    from recsys_tpu_torch.train.trainer import Trainer

    if fault == "mean_bags":
        real_fwd = eb.bag_forward
        sizes = torch.tensor([1, 3, 7, 2, 5], dtype=torch.float32)
        monkeypatch.setattr(eb, "bag_forward", lambda t, i, lay: real_fwd(t, i, lay)
                            / sizes[None, :, None])
    else:
        real = Trainer._step_core

        def broken(self, *a, **kw):
            step = real(self, *a, **kw)

            def unchanged(state, batch):
                table = state.params["embedding"]["table"]
                saved = table.clone()
                new, metrics = step(state, batch)
                with torch.no_grad():
                    table.copy_(saved)
                return new, metrics

            def half(state, batch):
                b = batch["label"].shape[0] // 2
                return step(state, {k: v[:b] for k, v in batch.items()})

            return {"unchanged": unchanged, "half": half}[fault]

        monkeypatch.setattr(Trainer, "_step_core", broken)
    out = _run(dlrm_root)
    assert not out["correct"], out["checks"]


def test_the_control_and_the_planted_faults_fail_the_limits(dlrm_root, monkeypatch, capsys):
    monkeypatch.setattr(harness, "HERE", dlrm_root)
    real_cell, real_driver = harness.load_cell, harness.load_driver
    monkeypatch.setattr(harness, "load_cell", lambda n, root=dlrm_root: real_cell(n, root))
    monkeypatch.setattr(harness, "load_driver", lambda n, root=dlrm_root: real_driver(n, root))
    control_dlrm.main(["--workload", CELL, "--seeds", "17", "18", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2
    for line in lines:
        limits = line["limits"]
        for reading in [k for k in line if k.startswith(("control", "fault"))]:
            nums = line[reading]
            assert any(nums[n] > lim for n, lim in limits.items()), (reading, nums, limits)
        assert all(line["self"][n] <= lim for n, lim in limits.items())
