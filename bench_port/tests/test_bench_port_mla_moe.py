"""The MLA-MoE cell's files: its configuration and cell, its data generator,
its counts against hand counts, its readers on a fake kineto list with and
without their spans, the reference's checks of the program's expert
choices and negatives, and whole tiny runs of the cell on the CPU (sound,
and the control and faults that set its limits)."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from bench_port import control_mla_moe, harness, mla_moe_datagen, tracing
from bench_port.reference import mla_moe as reference
from bench_port.work import mla_moe as work
from bench_port.work.peaks import BF16_FLOPS

CELL = "mlamoe-train-longseq"
CONFIG = "dsv2lite-seqrec-ep8-l4096"
NEW_METRICS = {"mla_attn_fwd_roofline", "mla_attn_bwd_roofline", "moe_experts_roofline",
               "mfu.train.mlamoe"}
# the tiny cell: d 64, 2 layers (one dense, one MoE) of 2 heads, 16 experts
# of width 32 scored, 4 held, top 3, one shared, ~20-event histories; one
# bf16 rounding that falls the other way moves a leaf of a few thousand
# elements by ~1e-4 (the limits of tests/test_torch_mla_moe.py's steps)
TINY_LIMITS = {"loss_gap": 3e-4, "grad_gap": 3e-3, "change_gap": 2e-3}


@pytest.fixture
def mla_root(tiny_root):
    """``tiny_root`` with the MLA-MoE configuration cut to the tiny widths
    above, 50 items, 8 negatives, histories of median 20, and its cell to
    6 histories a step, 3 steps an epoch."""
    p = os.path.join(tiny_root, "configs", f"{CONFIG}.json")
    with open(p) as f:
        c = json.load(f)
    c["model"].update(embedding_dim=64, mla_layers=2, mla_dense_layers=1, mla_heads=2,
                      mla_kv_rank=32, mla_nope_dim=16, mla_rope_dim=16, mla_v_dim=16,
                      mla_dense_width=96, moe_experts=16, moe_experts_held=4, moe_top_k=3,
                      moe_shared=1, moe_width=32, hstu_max_len=80, hstu_items=50,
                      hstu_negatives=8, yarn_original_max=80)
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
    c = cell.config
    assert c["name"] == CONFIG and cell.spec["chips"] == 1
    assert cell.spec["driver"] == "train_mla_moe_epoch"
    assert cell.spec["traffic"] == {"batch": 48, "steps_per_epoch": 8, "checked_steps": 3}
    assert set(cell.spec["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert c["papers"] == ["https://arxiv.org/abs/2405.04434"]
    assert set(c["reduced"]) == {"num_hidden_layers", "n_routed_experts"}
    assert {"vocab_size", "max_position_embeddings", "rope_deinterleave"} <= set(c["changed"])
    assert {"aux_loss_alpha", "adam", "init", "mixed_precision", "traffic"} <= set(c["assumed"])
    assert c["deployment"] and c["memory_estimate"] and c["memory_measured"]
    pub, m = c["published"], c["model"]
    assert (pub["num_hidden_layers"], pub["n_routed_experts"]) == (27, 64)
    assert (c["num_hidden_layers"], c["n_routed_experts"]) == (5, 8)
    assert (m["mla_layers"], m["moe_experts"], m["moe_experts_held"]) == (5, 64, 8)
    assert m["arch"] == "mla_moe" and m["embedding_dim"] == pub["hidden_size"]
    bench = harness.load_benchmark()
    entry = [x for x in bench["configs"] if x["name"] == CONFIG][0]
    assert entry["source"] == c["source"] and entry["file"] == f"bench_port/configs/{CONFIG}.json"
    assert sorted(entry["reduced"]) == sorted(c["reduced"])
    assert {x["name"] for x in harness.cell_metrics(bench, CELL, "per_layer")} == {
        "train.device_ms_per_step", "device.idle_share.train", "device.peak_mem_gib.train",
        *NEW_METRICS}
    assert {x["name"] for x in harness.cell_metrics(bench, CELL, "end_to_end")} == {
        "train_examples_per_s", "setup_s"}
    for other in ("scale-train-cbns", "dlrm-train-mhot", "hstu-train-longseq"):
        assert not {x["name"] for x in harness.cell_metrics(bench, other, "per_layer")} & (
            NEW_METRICS)


def test_histories_and_weights_are_made_by_the_seed_alone_at_the_published_widths():
    c = _config()
    a = mla_moe_datagen.histories(5, c, 64, "cpu")
    b = mla_moe_datagen.histories(5, c, 64, "cpu")
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    lens = a["lengths"]
    assert lens.min() >= 32 and lens.max() <= 4096 and int(lens.sum()) == a["items"].shape[0]
    assert a["items"].min() >= 1 and a["items"].max() <= c["model"]["hstu_items"]
    assert not torch.equal(mla_moe_datagen.histories(6, c, 64, "cpu")["items"][:100],
                           a["items"][:100])
    m = dict(c["model"], hstu_items=10, mla_layers=2, mla_dense_width=256, moe_width=128)
    w = mla_moe_datagen.weights(3, m, "cpu")
    assert torch.equal(w["layer_1"]["router"]["w"], mla_moe_datagen.weights(3, m, "cpu")[
        "layer_1"]["router"]["w"])
    assert w["layer_0"]["q"]["w"].shape == (2048, 16 * 192)
    assert w["layer_0"]["kv_a"]["w"].shape == (2048, 512 + 64)
    assert w["layer_0"]["kv_b"]["w"].shape == (512, 16 * 256)
    assert w["layer_0"]["o"]["w"].shape == (16 * 128, 2048)
    assert w["layer_1"]["router"]["w"].shape == (2048, 64)
    assert w["layer_1"]["experts"]["gate"].shape == (8, 2048, 128)
    assert w["layer_1"]["shared"]["up"]["w"].shape == (2048, 2 * 128)
    assert "mlp" in w["layer_0"] and "experts" not in w["layer_0"]
    assert w["item_table"].shape == (11, 2048) and not w["item_table"][0].any()


def test_counts_against_hand_counts():
    m = {"embedding_dim": 8, "mla_heads": 2, "mla_nope_dim": 4, "mla_rope_dim": 2,
         "mla_v_dim": 4, "mla_kv_rank": 3, "mla_layers": 3, "mla_dense_layers": 1,
         "mla_dense_width": 5, "moe_experts": 6, "moe_shared": 2, "moe_width": 7,
         "hstu_negatives": 4}
    # a row and layer: W_q 8 x 12, W_kv_a 8 x 5, W_kv_b 3 x 16, W_o 8 x 8;
    # a pair, layer and head (6 + 4) wide; the dense layer 3 x 8 x 5 a row;
    # each of 2 MoE layers the router 8 x 6 and the shared 3 x 8 x 14 a row;
    # the routed 3 x 8 x 7 a pair on a held expert; (1 + 4) logits of 8 a
    # supervised event
    proj = 2 * (8 * 12 + 8 * 5 + 3 * 16 + 8 * 8)
    fwd = (3 * (proj * 10 + 2 * 2 * 10 * 30) + 6 * 8 * 5 * 10
           + 2 * (2 * 8 * 6 + 6 * 8 * 14) * 10 + 6 * 8 * 7 * 25 + 2 * 8 * 5 * (10 - 4))
    assert work.forward_step(m, events=10, pairs=30, histories=4, assignments=25) == fwd
    assert work.train_step(m, events=10, pairs=30, histories=4, assignments=25) == 3 * fwd
    assert work.mla_attn_fwd(events=10, pairs=30, heads=2, dqk=6, dv=4) == (
        2 * 30 * 2 * 10, 10 * 2 * (2 * 16 + 4 * 4 + 4), "bf16")
    assert work.mla_attn_bwd(events=10, pairs=30, heads=2, dqk=6, dv=4) == (
        4 * 30 * 2 * 10, 10 * 2 * (2 * 20 + 8 + 4 * 16), "bf16")
    assert work.moe_experts(pairs=25, d=8, width=7, direction="fwd") == (
        6 * 25 * 8 * 7, 25 * 6 * 8, "bf16")
    assert work.moe_experts(pairs=25, d=8, width=7, direction="bwd") == (
        12 * 25 * 8 * 7, 25 * (10 * 8 + 10 * 7), "bf16")


class _Event:
    """A kineto event as ``tracing.reduce`` reads it."""

    def __init__(self, device, name, start, dur, corr, linked=0, thread=1):
        self.device, self._name, self.start, self.dur = device, name, start, dur
        self.corr, self.linked, self.thread = corr, linked, thread

    def device_type(self):
        return self.device

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def start_thread_id(self):
        return self.thread

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return False


ATTN = {"events": 69_000, "pairs": 84_000_000, "heads": 16, "dqk": 192, "dv": 128}
EXPERTS = {"pairs": 68_000, "d": 2048, "width": 1408}


def _kineto(ops):
    """A window of 1,000 s holding, for each (op, shape, device ns), a span
    ``bench.op.<op>|...`` around a launch whose kernel takes that long."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [_Event(cpu, tracing.WINDOW, 0, 10**12, 1)]
    t, corr = 1000, 10
    for op, shape, ns in ops:
        events.append(_Event(cpu, tracing.span_name(f"bench.op.{op}", **shape), t, ns + 200,
                             corr))
        events.append(_Event(cpu, "aten::launch", t + 10, 20, corr + 1))
        events.append(_Event(gpu, f"{op}_kernel", t + 50, ns, corr + 2, linked=corr + 1))
        t, corr = t + ns + 1000, corr + 3
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("metric,op,shape,count", [
    ("mla_attn_fwd_roofline", "mla_attn_fwd", ATTN, work.mla_attn_fwd),
    ("mla_attn_bwd_roofline", "mla_attn_bwd", ATTN, work.mla_attn_bwd),
    ("moe_experts_roofline", "moe_experts", dict(EXPERTS, direction="fwd"), work.moe_experts),
    ("moe_experts_roofline", "moe_experts", dict(EXPERTS, direction="bwd"), work.moe_experts)])
def test_the_rooflines_read_their_spans_on_a_kineto_list(metric, op, shape, count):
    """The experts' spans carry no pairs (they stay on the device): the
    reader takes a layer's from the step's counter over the MoE layers."""
    reader = harness.load_metric(metric)
    flops, _, _ = count(**shape)
    ns = int(round(4 * flops / BF16_FLOPS * 1e9))
    ctx = SimpleNamespace(config=_config())
    layers = ctx.config["model"]["mla_layers"] - ctx.config["model"]["mla_dense_layers"]
    stats = {"assignments_per_step": shape["pairs"] * layers} if op == "moe_experts" else {}
    spanned = {k: v for k, v in shape.items() if op != "moe_experts" or k != "pairs"}
    share, note = reader.read({"trace": tracing.reduce(_kineto([(op, spanned, ns)] * 2)),
                               "stats": stats}, ctx)
    assert share == pytest.approx(25.0, rel=1e-6) and "flops" in note and "2 calls" in note
    # another op's spans (the parent's program, another cell), or no trace
    other = "hstu_attn_fwd" if op != "hstu_attn_fwd" else "topk"
    assert reader.read({"trace": tracing.reduce(_kineto([(other, spanned, ns)])),
                        "stats": stats}, ctx) is None
    assert reader.read({"trace": None, "stats": stats}, ctx) is None
    if op == "moe_experts":
        # a program without the counter, or a cell of another model: nothing
        trace = tracing.reduce(_kineto([(op, spanned, ns)]))
        assert reader.read({"trace": trace, "stats": {}}, ctx) is None
        assert reader.read({"trace": trace, "stats": stats},
                           SimpleNamespace(config={"model": {}})) is None


def test_mfu_reads_the_counters_of_the_window():
    reader = harness.load_metric("mfu.train.mlamoe")
    ctx = SimpleNamespace(config=_config())
    stats = {"steps": 16, "window_s": 14.0, "batch": 48, "events_per_step": 69_000.0,
             "pairs_per_step": 8.4e7, "assignments_per_step": 2.7e5}
    per = work.train_step(ctx.config["model"], 69_000.0, 8.4e7, 48, 2.7e5)
    assert reader.read({"stats": stats}, ctx) == pytest.approx(
        100.0 * per * 16 / 14.0 / BF16_FLOPS)
    # a program without the counters, or a cell of another model: nothing
    assert reader.read({"stats": {k: v for k, v in stats.items()
                                  if k != "assignments_per_step"}}, ctx) is None
    assert reader.read({"stats": stats}, SimpleNamespace(config={"model": {}})) is None


def _choices():
    """Reference scores of 3 tokens over 5 experts (top 2): token 1's
    second (expert 4, 0.2) and third (expert 0, 0.195) lie within the tie
    margin, token 2's not."""
    return {1: torch.tensor([[0.5, 0.3, 0.1, 0.05, 0.05], [0.195, 0.1, 0.105, 0.4, 0.2],
                             [0.3, 0.05, 0.6, 0.04, 0.01]])}


@pytest.mark.parametrize("program,strict,fault,differ", [
    ([[1, 0], [4, 3], [0, 2]], True, "", 0),          # the same sets, in another order
    ([[0, 1], [3, 0], [2, 0]], True, "", 1),          # token 1 inside the tie margin
    ([[0, 1], [3, 1], [2, 0]], True, "token 1", 1),   # a near tie, but a far expert chosen
    ([[0, 1], [3, 4], [2, 1]], True, "token 2", 1),   # token 2 far from a tie
    ([[0, 1], [3, 4], [2, 1]], False, "", 1)])        # after an update: only counted
def test_the_reference_refuses_a_wrong_expert_choice(program, strict, fault, differ):
    got, n_differ, checked, _, ties = reference.choices_fault(
        {1: torch.tensor(program)}, _choices(), 2, strict=strict)
    assert (fault in got if fault else got == "") and n_differ == differ and checked == 3
    assert ties == (1 if strict else 0)   # token 1's 2nd and 3rd lie 2.5% apart


@pytest.mark.parametrize("third,fault", [(0.291, ""), (0.276, "token 0")])
def test_the_reference_refuses_a_choice_past_the_tie_margin(third, fault):
    """The 3rd expert taken for the 2nd: allowed 3% short of it (a tie), a
    fault 8% short (which a margin of 10% let pass)."""
    scores = {1: torch.tensor([[0.5, 0.3, third, 0.01, 0.01]])}
    got, n_differ, _, worst, ties = reference.choices_fault({1: torch.tensor([[0, 2]])},
                                                            scores, 2)
    assert (fault in got if fault else got == "") and n_differ == 1
    assert ties == (0 if fault else 1) and worst == pytest.approx(1 - third / 0.3)


@pytest.mark.parametrize("bad,what", [("range_low", "negatives in"),
                                      ("range_high", "negatives in"),
                                      ("skewed", "off uniform")])
def test_the_reference_refuses_a_bad_negative(bad, what):
    items = 1000
    gen = torch.Generator().manual_seed(4)
    neg = torch.randint(1, items + 1, (500, 64), generator=gen)
    assert reference.negatives_fault(neg, items) == ""
    if bad == "range_low":
        neg = neg - 1
    elif bad == "range_high":
        neg = neg.clone()
        neg[7, 3] = items + 1
    else:
        neg = (neg - 1) % (items // 2) + 1
    assert what in reference.negatives_fault(neg, items)


def test_a_sound_tiny_run_is_correct_and_traced(mla_root):
    out = _run(mla_root, trace=True)
    assert out["correct"], out["checks"]
    # the CPU has no device events for the rooflines to read: the MFU alone
    assert out["attempted"] > 0 and out["metrics"]["mfu.train.mlamoe"]["value"] > 0
    out = _run(mla_root, seed=17)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}


def test_a_step_with_the_gates_renormalised_is_not_correct(mla_root, monkeypatch):
    from recsys_tpu_torch.ops import moe

    real = moe.route

    def renormalised(*a, **kw):
        r = real(*a, **kw)
        return r._replace(weights=r.weights / r.weights.sum(dim=1, keepdim=True))

    monkeypatch.setattr(moe, "route", renormalised)
    out = _run(mla_root)
    assert not out["correct"], out["checks"]


def test_the_control_and_the_planted_faults_fail_the_limits(mla_root, monkeypatch, capsys):
    monkeypatch.setattr(harness, "HERE", mla_root)
    real_cell, real_driver = harness.load_cell, harness.load_driver
    monkeypatch.setattr(harness, "load_cell", lambda n, root=mla_root: real_cell(n, root))
    monkeypatch.setattr(harness, "load_driver", lambda n, root=mla_root: real_driver(n, root))
    control_mla_moe.main(["--workload", CELL, "--seeds", "17", "18", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    lines = [x for x in lines if "limits" in x]
    assert len(lines) == 2
    for line in lines:
        assert not line["check"]["fault"], line["check"]
        limits = line["limits"]
        for reading in ("control_fp8", "fault_plain_rope", "fault_renorm", "fault_no_shared"):
            nums = line[reading]
            assert any(nums[n] > lim for n, lim in limits.items()), (reading, nums, limits)
        for sound in ("self", "program"):
            assert all(line[sound][n] <= lim for n, lim in limits.items()), line[sound]
