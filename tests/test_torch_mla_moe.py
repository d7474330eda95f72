"""MLA-MoE in the port (``models/mla_moe.py``, the plain versions of kernel
rows 14 to 16 in ``ops/mla_attention.py`` and ``ops/moe.py``, row 13 at
D = 2,048, ``Trainer`` and the train CLI) against the plain reference
(``tests/reference/mla_moe.py``) on seeded random weights, at a small size
on the CPU: d 64, 2 heads of 16 nope + 16 rope (values 16), kv rank 32,
16 experts of width 32 scored, 4 held, top-3, one shared, a few jagged
histories. The kernels themselves run only on the card: ``chip_smoke.py
--mla-moe`` holds them to these plain versions there, at the benchmark
cell's shape.

Tolerances, each with its reason: ``RTOL`` of the largest value where
two computations take the same products in another order of fp32 sums;
``ATTN_RTOL`` for the attention's plain version against a textbook
softmax attention under bf16 operands (p rounded to bf16 before the
softmax's normalisation there, after it here); three whole steps under
the benchmark's own numbers (``bench_port/compare.py``) and
``STEP_LIMITS``, which the fp8 control and three planted faults fail.
"""

import ast
import copy
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from bench_port import compare
from bench_port.reference.hstu import leaves, program_readings
from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.models import mla_moe
from recsys_tpu_torch.ops import hstu_attention as ha
from recsys_tpu_torch.ops import mla_attention as ma
from recsys_tpu_torch.ops import moe
from recsys_tpu_torch.ops import sampled_softmax as ss
from recsys_tpu_torch.train.trainer import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location("mla_moe_reference",
                                               os.path.join(HERE, "reference", "mla_moe.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

CONFIG = os.path.join(REPO, "bench_port", "configs", "dsv2lite-seqrec-ep8-l4096.json")
EDGE_LENGTHS = (1, 2, 63, 64, 65, 130)
RTOL = 2e-5
ATTN_RTOL = 2e-2
# three steps at this size: the sound runs read ~1e-4 / 7e-4 / 5e-4; the
# reference in fp32 (one precision above the program's) ~7e-4 / 1.5e-3 /
# 8e-4, the faults (RoPE's plain frequencies, the gates renormalised, the
# shared expert left out) 5e-4 / 7e-2, 2e-3 / 0.3, 6e-3 / 9: a tiny model,
# where one bf16 rounding that falls the other way moves a leaf by ~1e-4
STEP_LIMITS = {"loss_gap": 3e-4, "grad_gap": 3e-3, "change_gap": 2e-3}


def _model(**kw) -> ModelConfig:
    base = dict(arch="mla_moe", embedding_dim=64, hstu_max_len=160, hstu_items=50,
                hstu_negatives=8, softmax_temperature=0.05)
    return ModelConfig(**{**base, **kw})


def _config(model=None, **train) -> RecsysConfig:
    t = dict(batch_size=4, optimizer="adam", learning_rate=1e-3, lr_decay_rate=1.0,
             clipnorm=0.0, async_checkpoint=False, epochs=2)
    return RecsysConfig(model=model or _model(), train=TrainConfig(**{**t, **train}))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float(torch.max(torch.abs(a - b))) / max(float(torch.max(torch.abs(b))), 1e-30)


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


# ---- the configuration ------------------------------------------------------

def test_config_file_holds_the_published_values_and_names_each_cut():
    with open(CONFIG) as f:
        c = json.load(f)
    for key, want in c["published"].items():
        if key not in c["reduced"]:
            assert c[key] == want, key
    assert set(c["reduced"]) == {"num_hidden_layers", "n_routed_experts"}
    assert (c["num_hidden_layers"], c["n_routed_experts"]) == (5, 8)
    assert (c["published"]["num_hidden_layers"], c["published"]["n_routed_experts"]) == (27, 64)
    m, pub = ModelConfig(**c["model"]), c["published"]
    assert (m.embedding_dim, m.mla_heads, m.mla_kv_rank, m.mla_nope_dim, m.mla_rope_dim,
            m.mla_v_dim) == (pub["hidden_size"], pub["num_attention_heads"],
                             pub["kv_lora_rank"], pub["qk_nope_head_dim"],
                             pub["qk_rope_head_dim"], pub["v_head_dim"])
    assert (m.mla_dense_width, m.moe_width, m.moe_experts, m.moe_top_k, m.moe_shared) == (
        pub["intermediate_size"], pub["moe_intermediate_size"], pub["n_routed_experts"],
        pub["num_experts_per_tok"], pub["n_shared_experts"])
    rs = pub["rope_scaling"]
    assert (m.yarn_factor, m.yarn_original_max, m.yarn_beta_fast, m.yarn_beta_slow,
            m.yarn_mscale, m.yarn_mscale_all_dim) == (
        rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
        rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    assert (m.mla_layers, m.mla_dense_layers, m.moe_experts_held) == (5, 1, 8)
    assert m.hstu_max_len == rs["original_max_position_embeddings"]
    assert {"aux_loss_alpha", "adam", "init", "traffic"} <= set(c["assumed"])


def test_mla_moe_config_round_trips_and_keeps_other_architectures_json():
    cfg = _config()
    assert RecsysConfig.from_json(cfg.to_json()) == cfg
    d = cfg.to_dict()["model"]
    assert "mla_heads" in d and "hstu_items" in d and "hstu_blocks" not in d
    assert "table_rows" not in d
    for other in (RecsysConfig(), RecsysConfig(model=ModelConfig(arch="hstu"))):
        assert "mla_heads" not in other.to_dict()["model"]


@pytest.mark.parametrize("bad", [dict(moe_top_k=17), dict(moe_experts_held=17),
                                 dict(moe_experts_held=0), dict(mla_rope_dim=15),
                                 dict(mla_dense_layers=3), dict(softmax_temperature=0.0)])
def test_model_config_refuses_a_bad_mla_moe(bad):
    with pytest.raises(ValueError):
        _model(**bad)


@pytest.mark.parametrize("train", [dict(optimizer="adagrad"), dict(clipnorm=1.0),
                                   dict(negative_cache=8)])
def test_mla_moe_trainer_refuses_the_modes_it_does_not_train_in(tmp_path, train):
    with pytest.raises(ValueError, match="mla_moe"):
        Trainer(_config(**train), output_dir=str(tmp_path), device="cpu")


# ---- YaRN ---------------------------------------------------------------------

def test_yarn_frequencies_and_scale_at_the_published_values():
    with open(CONFIG) as f:
        m = ModelConfig(**json.load(f)["model"])
    inv = mla_moe.yarn_inv_freq(m).double()
    f = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # the ramp runs from floor(corr(32)) = 10 to ceil(corr(1)) = 23
    assert torch.allclose(inv[:11], f[:11], rtol=1e-6)
    assert torch.allclose(inv[23:], f[23:] / 40, rtol=1e-6)
    r = (torch.arange(11, 23, dtype=torch.float64) - 10) / 13
    assert torch.allclose(inv[11:23], f[11:23] / 40 * r + f[11:23] * (1 - r), rtol=1e-6)
    assert mla_moe.softmax_scale(m) == pytest.approx(0.114721, rel=1e-5)
    cos, sin = ref.rope_tables(dict(json.load(open(CONFIG))["model"]), 4096, "cpu")
    got_cos, got_sin = mla_moe._rope_table(m, torch.device("cpu"))
    assert _rel(got_cos, cos) < 1e-5 and _rel(got_sin, sin) < 1e-5


def test_rope_keeps_position_zero_and_each_pair_s_norm():
    m = _model()
    x = torch.randn(5, 2, m.mla_rope_dim, generator=torch.Generator().manual_seed(1))
    out = mla_moe.rope(x, torch.tensor([0, 1, 2, 3, 159]), m)
    assert torch.equal(out[0], x[0])
    half = m.mla_rope_dim // 2
    norm = (x[..., :half] ** 2 + x[..., half:] ** 2)
    assert torch.allclose(out[..., :half] ** 2 + out[..., half:] ** 2, norm, rtol=1e-5)


# ---- rows 14 and 15: the attention -------------------------------------------

def _textbook_attention(q, k, v, lengths, heads, scale, bf16):
    """softmax(tau q k^T) v, causal, a history at a time (rounding p after
    the normalisation under bf16)."""
    out, start = [], 0
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    for n in lengths:
        qh, kh, vh = (rnd(t[start:start + n]).reshape(n, heads, -1).transpose(0, 1)
                      for t in (q, k, v))
        s = qh @ kh.transpose(1, 2) * scale
        s = s.masked_fill(~torch.tril(torch.ones(n, n, dtype=torch.bool)), -math.inf)
        out.append((rnd(torch.softmax(s, -1)) @ vh).transpose(0, 1).reshape(n, -1))
        start += n
    return torch.cat(out)


@pytest.mark.parametrize("bf16,heads", [(False, 1), (False, 2), (True, 2)])
def test_attention_plain_version_follows_a_textbook_softmax_at_edge_lengths(bf16, heads):
    lay = ha.make_layout(torch.tensor(EDGE_LENGTHS))
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(lay.events, heads * 24, generator=g) for _ in range(2))
    v = torch.randn(lay.events, heads * 16, generator=g)
    do = torch.randn(lay.events, heads * 16, generator=g)
    leaves_ = [t.requires_grad_(True) for t in (q, k, v)]
    got = ma.mla_attention(q, k, v, lay, heads, 0.3, bf16)
    want = _textbook_attention(q, k, v, EDGE_LENGTHS, heads, 0.3, bf16)
    tol = ATTN_RTOL if bf16 else RTOL
    assert _rel(got, want) < tol
    for a, b in zip(torch.autograd.grad(got, leaves_, do), torch.autograd.grad(want, leaves_, do)):
        assert _rel(a, b) < tol


def test_attention_refuses_other_widths_off_the_cpu():
    lay = ha.make_layout(torch.tensor([5, 9]))
    q = torch.zeros((14, 2 * 32), device="meta")
    with pytest.raises(ValueError, match="192"):
        ma.mla_attention(q, q, q, lay, 2, 0.1)


# ---- row 16 and the routing ----------------------------------------------------

@pytest.mark.parametrize("weights", [False, True])
def test_grouped_product_plain_version_is_each_group_s_product(weights):
    g = torch.Generator().manual_seed(4)
    offsets = torch.tensor([0, 128, 128, 384], dtype=torch.int32)
    if weights:
        a, b = torch.randn(24, 384, generator=g), torch.randn(40, 384, generator=g)
    else:
        a, b = torch.randn(384, 24, generator=g), torch.randn(3, 40, 24, generator=g)
    out = moe.grouped_mm(a.to(torch.bfloat16), b.to(torch.bfloat16), offsets, weights)
    a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    for grp, (lo, hi) in enumerate([(0, 128), (128, 128), (128, 384)]):
        if weights:
            assert _rel(out[grp], a[:, lo:hi] @ b[:, lo:hi].t()) < RTOL if hi > lo else \
                torch.equal(out[grp], torch.zeros_like(out[grp]))
        elif hi > lo:
            assert _rel(out[lo:hi], a[lo:hi] @ b[grp].t()) < RTOL


def _routing(e=40, d=64, experts=16, k=3, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(e, d, generator=g)
    w = torch.randn(d, experts, generator=g) * 0.1
    return x, w, moe.route(x, w, k)


@pytest.mark.parametrize("skew", [False, True])
def test_dispatch_drops_no_token_and_pads_each_expert(skew):
    """Every held (token, slot) has one row inside its expert's padded
    range, the padding rows read nothing, and the host's bound holds the
    rows even when every token's top-k are all held (``skew``)."""
    x, w, r = _routing()
    held = 4
    if skew:
        scores = r.scores.clone()
        scores[:, :held] += 1.0   # experts 0..3 take every token's three slots
        r = moe.Routing(scores, *torch.topk(scores, 3, dim=1))
    disp = moe.dispatch(r, held)
    flat = r.experts.reshape(-1)
    want = int((flat < held).sum())
    assert want == int(disp.counts.sum()) == (3 * 40 if skew else want)
    assert disp.rows == moe.rows_bound(40, 3, held) and disp.rows % moe.PAD == 0
    bounds = disp.offsets.tolist()
    assert all(b % moe.PAD == 0 for b in bounds) and bounds[-1] <= disp.rows - moe.PAD
    slot_rows = disp.slot_rows.reshape(-1)
    rows = []
    for p in torch.nonzero(flat < held).reshape(-1).tolist():
        e, row = int(flat[p]), int(slot_rows[p])
        assert bounds[e] <= row < bounds[e + 1] and int(disp.src[row]) == p
        rows.append(row)
    assert len(set(rows)) == want
    assert int((slot_rows == disp.rows - 1).sum()) == flat.numel() - want
    # the padding rows, and the rows past the experts', read nothing
    assert int((disp.src >= 0).sum()) == want
    xp = moe.gather_rows(x, disp)
    assert torch.equal(xp[rows], x[torch.tensor(rows).new_tensor(
        [int(disp.src[q]) // 3 for q in rows])].to(torch.bfloat16))
    assert int(torch.count_nonzero(xp.float().abs().sum(1))) <= want


def test_a_held_expert_with_no_token_and_a_combine_bit_equal_twice():
    x, w, r = _routing()
    scores = r.scores.clone()
    scores[:, 2] = -1.0   # expert 2 is never chosen
    r = moe.Routing(scores, *torch.topk(scores, 3, dim=1))
    disp = moe.dispatch(r, 4)
    assert int(disp.counts[2]) == 0 and disp.offsets[2] == disp.offsets[3]
    g = torch.Generator().manual_seed(6)
    wgu, wd = torch.randn(4, 64, 64, generator=g) * 0.1, torch.randn(4, 32, 64, generator=g) * 0.1
    leaves_ = [t.requires_grad_(True) for t in (x, wgu, wd)]
    runs = []
    for _ in range(2):
        out = moe.routed(x, wgu, wd, r, disp)
        runs.append([out, *torch.autograd.grad(out, leaves_, torch.ones_like(out))])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][3][2], torch.zeros_like(wd[2]))


def test_balance_loss_follows_its_definition_history_by_history():
    x, w, r = _routing(e=30)
    lay = ha.make_layout(torch.tensor([7, 1, 22]))
    got = moe.balance_loss(r, lay.seq, 3, 0.01)
    want, start = 0.0, 0
    for n in (7, 1, 22):
        ch, s = r.experts[start:start + n], r.scores[start:start + n]
        f = torch.stack([(ch == e).any(1).float().sum() for e in range(16)]) * 16 / (3 * n)
        want += float((f * s.mean(0)).sum())
        start += n
    assert float(got) == pytest.approx(0.01 * want / 3, rel=1e-6)


def test_the_shares_of_every_card_add_up_to_the_uncut_layer():
    """Four cards of 4 experts each: the held experts' parts of each card,
    with the shared expert counted once, add up to the reference's layer
    with all 16 experts held."""
    m = _model(moe_experts=16, moe_experts_held=4, moe_top_k=3, mla_layers=2)
    p = mla_moe.init(7, m, "cpu")["layer_1"]
    whole = mla_moe.init(7, _model(moe_experts=16, moe_experts_held=16, moe_top_k=3,
                                   mla_layers=2), "cpu")["layer_1"]
    whole["router"], whole["shared"] = p["router"], p["shared"]
    g = torch.Generator().manual_seed(8)
    x = torch.randn(50, 64, generator=g)
    routing = moe.route(x, whole["router"]["w"], 3)
    parts = mla_moe.swiglu(p["shared"], x, True)
    for card in range(4):
        held = slice(4 * card, 4 * card + 4)
        # the card's experts are its 0..3: the router's columns turned so
        order = torch.roll(torch.arange(16), -4 * card)
        r = moe.route(x, whole["router"]["w"][:, order], 3)
        ex = {k: whole["experts"][k][held] for k in ("gate", "up", "down")}
        parts = parts + moe.routed(x, torch.cat([ex["gate"], ex["up"]], 2), ex["down"], r,
                                   moe.dispatch(r, 4))
    model = dict(_config(_model(moe_experts=16, moe_experts_held=16, moe_top_k=3))
                 .to_dict()["model"])
    want, _ = ref._moe(whole, model, x[None], torch.ones(1, 50, dtype=torch.bool),
                       routing.experts[None], "bf16", "")
    assert _rel(parts, want[0]) < RTOL


# ---- row 13 at D = 2,048 -------------------------------------------------------

def test_sampled_softmax_at_the_hidden_width_of_2048():
    g = torch.Generator().manual_seed(9)
    q = torch.nn.functional.normalize(torch.randn(12, 2048, generator=g), dim=1)
    table = torch.nn.functional.normalize(torch.randn(20, 2048, generator=g), dim=1)
    pos, neg = torch.randint(0, 20, (12,), generator=g), torch.randint(0, 20, (12, 6), generator=g)
    q.requires_grad_(True)
    table.requires_grad_(True)
    loss = ss.sampled_softmax(q, table, pos, neg, 0.05)
    lp = (q * table[pos]).sum(1) / 0.05
    ln = torch.einsum("mkd,md->mk", table[neg], q) / 0.05
    ln = torch.where(neg == pos[:, None], -math.inf, ln)
    want = (torch.logsumexp(torch.cat([lp[:, None], ln], 1), 1) - lp).mean()
    for a, b in zip([loss, *torch.autograd.grad(loss, [q, table])],
                    [want, *torch.autograd.grad(want, [q, table])]):
        assert _rel(a, b) <= RTOL
    assert 2048 in ss.WIDTHS


# ---- the model and the trainer ---------------------------------------------------

def _three_steps(tmp_path, seed: int):
    """Three trainer steps from seeded weights -> (program readings, the
    initial params, the recorded steps)."""
    cfg = _config()
    tr = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    state = tr.init_state(0, 0, seed)
    p0 = _tree({k: v.detach().clone() for k, v in leaves(state.params).items()})
    rng = np.random.default_rng(seed % (1 << 32))
    step = tr.make_train_step(None)
    tr.record_steps = []
    losses, mu1 = [], None
    for s in range(3):
        lens = rng.integers(1, 60, 4)
        batch = {"items": torch.as_tensor(rng.integers(1, 51, int(lens.sum())).astype(np.int32)),
                 "lengths": torch.as_tensor(lens)}
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        if s == 0:
            mu1 = copy.deepcopy(state.opt_state["mu"])
    return program_readings(losses, mu1, state.params, p0), p0, tr.record_steps


def _follow(p0, steps, fmt="bf16", fault="", check=None):
    cfg = _config().to_dict()
    return ref.follow_steps(p0, steps, cfg["model"], cfg["train"], fmt, fault, check)


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
def test_three_trainer_steps_follow_the_reference(tmp_path, seed):
    prog, p0, steps = _three_steps(tmp_path, seed)
    check = {}
    want = _follow(p0, steps, check=check)
    assert not check["fault"], check
    ok, checks = compare.judge(compare.train_numbers(prog, want), STEP_LIMITS)
    assert ok, checks


@pytest.mark.parametrize("fmt,fault", [("fp8", ""), ("bf16", "plain_rope"),
                                       ("bf16", "renorm"), ("bf16", "no_shared")])
def test_the_fp8_control_and_the_planted_faults_fail_the_limits(tmp_path, fmt, fault):
    _, p0, steps = _three_steps(tmp_path, 11)
    numbers = compare.train_numbers(_follow(p0, steps, fmt, fault), _follow(p0, steps))
    ok, checks = compare.judge(numbers, STEP_LIMITS)
    assert not ok, checks


def test_the_epoch_records_each_step_s_choices_for_every_moe_layer(tmp_path):
    tr = Trainer(_config(), output_dir=str(tmp_path), device="cpu")
    state = tr.init_state(0, 0, 3)
    lengths = np.random.default_rng(2).integers(1, 81, 10)
    data = {"items": torch.as_tensor(np.random.default_rng(3).integers(
        1, 51, int(lengths.sum())).astype(np.int32)), "lengths": torch.as_tensor(lengths)}
    epoch = tr.make_train_epoch(None, 10, 2)
    tr.record_steps = []
    state, metrics = epoch(state, data, 0)
    assert state.step == 2 and len(tr.record_steps) == 2
    for rec in tr.record_steps:
        e = int(rec["lengths"].sum())
        assert sorted(rec["experts"]) == [1] and rec["experts"][1].shape == (e, 3)
    assert 0 < float(metrics["moe_assignments"]) <= float(metrics["events"]) * 3
    assert float(metrics["moe_max_expert_tokens"]) <= float(metrics["moe_assignments"])
    assert float(metrics["balance_loss"]) > 0


def _bundle(path: str) -> str:
    rng = np.random.default_rng(3)

    def split(n):
        lengths = rng.integers(1, 60, n)
        return {"items": rng.integers(1, 51, int(lengths.sum())).astype(np.int32),
                "lengths": lengths.astype(np.int64)}

    np.savez(path, **{f"{s}/{k}": v for s, n in (("train", 16), ("val", 6))
                      for k, v in split(n).items()})
    return path


def test_train_cli_trains_mla_moe_from_a_config(tmp_path):
    from recsys_tpu_torch.train import __main__ as cli

    conf = str(tmp_path / "mla_moe.json")
    _config().save(conf)
    data = _bundle(str(tmp_path / "bundle.npz"))
    out = tmp_path / "run"
    assert cli.main(["--config", conf, "--data", data, "--device", "cpu",
                     "--output_dir", str(out), "--set", "train.epochs=2"]) == 0
    with open(out / "metrics.json") as f:
        report = json.load(f)
    assert np.isfinite(report["val_loss"]) and report["epochs_run"] == 2
    assert RecsysConfig.load(str(out / "config.json")).model.arch == "mla_moe"


def test_dryrun_takes_mla_moe_from_its_config(tmp_path, capsys):
    from recsys_tpu_torch.train import dryrun

    conf = str(tmp_path / "mla_moe.json")
    _config(_model(hstu_items=5000)).save(conf)
    assert dryrun.main(["--config", conf, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["moe_assignments"] > 0


# ---- the reference stands alone ---------------------------------------------------

@pytest.mark.parametrize("path", ["tests/reference/mla_moe.py",
                                  "bench_port/reference/mla_moe.py"])
def test_reference_imports_no_jax_and_nothing_of_the_port(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"torch", "numpy", "math", "typing", "__future__", "bench_port"}, names
