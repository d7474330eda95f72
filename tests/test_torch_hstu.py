"""HSTU in the port (``models/hstu.py``, the plain versions of kernel rows
11 to 13 in ``ops/hstu_attention.py`` and ``ops/sampled_softmax.py``,
``Trainer`` and the train CLI) against the plain reference
(``tests/reference/hstu.py``) on seeded random weights, at a small size on
the CPU: d = 64, heads of 64, N = 200 or 80, a few jagged histories. The
kernels themselves run only on the card: ``chip_smoke.py --hstu`` holds
them to these plain versions there, at the benchmark cell's shape.

Tolerances, each with its reason: the plain versions and the reference
compute the same products on the same operands (rounded to bf16 alike
under ``bf16``), in another order of fp32 sums: ``RTOL`` of the largest
value for single ops, ``BF16_RTOL`` for a whole block of bf16 operands
(where a rounding can fall the other way); three whole steps under the
benchmark's own numbers (``bench_port/compare.py``) and ``STEP_LIMITS``,
which the fp8 control and each planted fault fail.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from bench_port import compare
from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.models import hstu
from recsys_tpu_torch.ops import hstu_attention as ha
from recsys_tpu_torch.ops import sampled_softmax as ss
from recsys_tpu_torch.train.trainer import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location("hstu_reference",
                                               os.path.join(HERE, "reference", "hstu.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

EDGE_LENGTHS = (1, 2, 63, 64, 65, 200)
RTOL = 2e-5
# bf16 operands: one rounding that falls the other way in a few hundred
# elements a leaf moves a gradient by ~1e-4 of the largest
BF16_RTOL = 1e-3
# three steps: over 9 seeds the sound runs read at most 2.6e-5 / 5.5e-5 /
# 9.8e-5; the fp8 control at least 5.8e-4 / 4.3e-3 / 5.2e-3, the faults
# (time bias left out, divided by n, diagonal dropped) at least 7.2e-4 /
# 2.1e-2 / 6.7e-3
STEP_LIMITS = {"loss_gap": 2e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
LR = 1e-3


def _model(**kw) -> ModelConfig:
    base = dict(arch="hstu", embedding_dim=64, hstu_max_len=80, hstu_blocks=2, hstu_heads=1,
                hstu_items=50, hstu_negatives=8, dropout_rate=0.2, softmax_temperature=0.05)
    return ModelConfig(**{**base, **kw})


def _config(model=None, **train) -> RecsysConfig:
    t = dict(batch_size=4, optimizer="adam", learning_rate=LR, lr_decay_rate=1.0,
             clipnorm=0.0, async_checkpoint=False, epochs=2)
    return RecsysConfig(model=model or _model(), train=TrainConfig(**{**t, **train}))


def _histories(seed: int, lengths, items: int = 50):
    """Jagged histories: ids, ascending timestamps (log-uniform gaps of 1 s
    to 30 days), lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int64)
    e = int(lengths.sum())
    gaps = np.exp(rng.uniform(0, np.log(2_592_000.0), e)).round().astype(np.int64)
    ts = np.concatenate([1_300_000_000 + np.cumsum(gaps[a:a + n]) for a, n in
                         zip(np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths)])
    return {"items": torch.as_tensor(rng.integers(1, items + 1, e).astype(np.int32)),
            "timestamps": torch.as_tensor(ts), "lengths": torch.as_tensor(lengths)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach(), b.detach()
    return float(torch.max(torch.abs(a - b))) / max(float(torch.max(torch.abs(b))), 1e-30)


# ---- the configuration ------------------------------------------------------

def test_config_file_holds_the_published_widths_and_the_one_length_change():
    with open(os.path.join(REPO, "bench_port", "configs", "hstu-ml20m-large-l4096.json")) as f:
        c = json.load(f)
    m, pub = ModelConfig(**c["model"]), c["published"]
    assert (m.embedding_dim, m.hstu_blocks, m.hstu_heads, ha.HEAD_DIM, ha.HEAD_DIM) == (
        pub["embedding_dim"], pub["num_blocks"], pub["num_heads"], pub["dqk"], pub["dv"])
    assert (m.dropout_rate, m.softmax_temperature, m.hstu_negatives) == (
        pub["dropout_rate"], pub["temperature"], pub["num_negatives"])
    assert c["reduced"] == [] and list(c["changed"]) == ["max_sequence_length"]
    assert (pub["max_sequence_length"], m.hstu_max_len) == (200, 4096)
    assert c["train"]["optimizer"] == "adam" and c["train"]["learning_rate"] == pub[
        "learning_rate"]


def test_hstu_config_round_trips_and_keeps_other_architectures_json():
    cfg = _config()
    assert RecsysConfig.from_json(cfg.to_json()) == cfg
    d = cfg.to_dict()["model"]
    assert "hstu_blocks" in d and "table_rows" not in d
    assert "hstu_blocks" not in RecsysConfig().to_dict()["model"]
    dlrm = RecsysConfig(model=ModelConfig(arch="dlrm_dcnv2", table_rows=(3,), bag_sizes=(1,),
                                          bottom_mlp_dims=(128,)))
    assert "hstu_blocks" not in dlrm.to_dict()["model"]


@pytest.mark.parametrize("bad", [dict(hstu_heads=0), dict(hstu_blocks=0),
                                 dict(dropout_rate=1.0), dict(softmax_temperature=0.0)])
def test_model_config_refuses_a_bad_hstu(bad):
    with pytest.raises(ValueError):
        _model(**bad)


@pytest.mark.parametrize("train", [dict(optimizer="adagrad"), dict(clipnorm=1.0),
                                   dict(negative_cache=8)])
def test_hstu_trainer_refuses_the_modes_it_does_not_train_in(tmp_path, train):
    with pytest.raises(ValueError, match="hstu"):
        Trainer(_config(**train), output_dir=str(tmp_path), device="cpu")


def test_hstu_trainer_refuses_fp32_operands_on_the_card():
    # the card's attention kernels take bf16 operands only; the CPU trains
    # either precision
    import types

    for mp in (True, False):
        Trainer._check_hstu(types.SimpleNamespace(
            config=_config(_model(mixed_precision=mp)), ctx=None, device=torch.device("cpu")))
    Trainer._check_hstu(types.SimpleNamespace(config=_config(), ctx=None,
                                              device=torch.device("cuda")))
    with pytest.raises(ValueError, match="mixed_precision=False on the card"):
        Trainer._check_hstu(types.SimpleNamespace(
            config=_config(_model(mixed_precision=False)), ctx=None,
            device=torch.device("cuda")))


# ---- the layout and the bias ------------------------------------------------

def test_layout_tiles_every_history_once_longest_sweeps_first():
    lengths = torch.tensor([1, 200, 64, 65, 0, 130])
    lay = ha.make_layout(lengths)
    assert (lay.events, lay.max_len) == (460, 200)
    assert lay.pairs == sum(n * (n + 1) // 2 for n in lengths.tolist())
    assert lay.offsets.tolist() == [0, 1, 201, 265, 330, 330, 460]
    assert lay.positions[:3].tolist() == [0, 0, 1] and lay.seq[-1] == 5
    want = {(b, t) for b, n in enumerate(lengths.tolist()) for t in range(-(-n // 64))}
    for tiles, key in ((lay.q_tiles, lambda b, t: t + 1),
                       (lay.k_tiles, lambda b, t: -(-int(lengths[b]) // 64) - t)):
        got = [tuple(x) for x in tiles.tolist() if x[0] >= 0]
        assert sorted(got) == sorted(want) and len(got) == len(want)
        work = [key(b, t) for b, t in got]
        assert work == sorted(work, reverse=True)
        assert all(x == [-1, 0] for x in tiles.tolist()[len(got):])


@pytest.mark.parametrize("lengths", [
    EDGE_LENGTHS + (0, 128, 4096),
    tuple(np.clip(np.random.default_rng(7).lognormal(np.log(1024), 1.0, 128), 1, 4096)
          .astype(np.int64)),
], ids=["edges", "lognormal"])
def test_layout_counts_the_causal_tile_pairs(lengths):
    # the (query tile, key tile) pairs that hold a causal pair (key <= query)
    # of some history, counted tile pair by tile pair
    lay = ha.make_layout(torch.tensor(lengths))
    want = 0
    for n in lengths:
        for qt in range(-(-n // ha.TILE)):
            for kt in range(-(-n // ha.TILE)):
                want += kt * ha.TILE <= min(n - 1, qt * ha.TILE + ha.TILE - 1)
    assert lay.tile_pairs == want
    assert lay.tile_pairs * ha.TILE ** 2 >= lay.pairs


@pytest.mark.parametrize("dt,want", [(0, 0), (1, 0), (-1, 0), (2, 2), (3, 3), (20, 9),
                                     (-20, 9), (3600, 27), (86_400, 37), (2_592_000, 49),
                                     (10**18, 128)])
def test_bucket_at_zero_one_second_and_thirty_days(dt, want):
    x = torch.tensor([dt], dtype=torch.int64)
    assert int(ha.bucket(x)) == int(ref.bucket(x)) == want


def test_bucket_changes_at_exact_powers():
    # around the first whole second of each bucket k, exp(0.301 k) rounded
    # up: both versions agree, and agree with the exact bucket wherever it
    # is not within fp32's reach of a whole number
    ks = torch.arange(1, 70, dtype=torch.float64)
    first = torch.ceil(torch.exp(ks * 0.301)).long()
    dt = torch.cat([first - 1, first, first + 1])
    got = ha.bucket(dt)
    assert torch.equal(got, ref.bucket(dt))
    exact = torch.log(dt.double()) / 0.301
    clear = torch.abs(exact - torch.round(exact)) > 1e-5
    assert clear.sum() > 100
    assert torch.equal(got[clear], torch.floor(exact[clear]).long())


def test_next_timestamps_shift_within_each_history():
    h = _histories(1, [3, 1, 2])
    lay = ha.make_layout(h["lengths"])
    t = h["timestamps"]
    assert ha.next_timestamps(t, lay).tolist() == [t[1], t[2], t[2], t[3], t[5], t[5]]


# ---- rows 11 and 12 ---------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_attention_plain_version_follows_the_reference_at_edge_lengths(bf16, heads):
    h = _histories(3, EDGE_LENGTHS)
    lay = ha.make_layout(h["lengths"])
    g = torch.Generator().manual_seed(heads)
    w, n_max = heads * ha.HEAD_DIM, 200
    v, q, k = (torch.randn((lay.events, w), generator=g) for _ in range(3))
    pos_w = torch.randn(2 * n_max - 1, generator=g) * 0.5
    ts_w = torch.randn(ha.NUM_BUCKETS + 1, generator=g) * 0.5
    gout = torch.randn((lay.events, w), generator=g)
    leaves = [t.requires_grad_(True) for t in (v, q, k, pos_w, ts_w)]
    got = ha.hstu_attention(v, q, k, pos_w, ts_w, h["timestamps"], lay, n_max, bf16)
    got = [got, *torch.autograd.grad(got, leaves, gout)]
    want = ref.attention(v, q, k, pos_w, ts_w, h["timestamps"], h["lengths"], n_max,
                         "bf16" if bf16 else "fp32")
    want = [want, *torch.autograd.grad(want, leaves, gout)]
    for name, a, b in zip(("out", "dv", "dq", "dk", "dpos_w", "dts_w"), got, want):
        assert _rel(a, b) <= RTOL, (name, _rel(a, b))
    # the first history's one event attends to itself alone
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    x = torch.dot(rnd(q[0, :64]), rnd(k[0, :64])) + pos_w[n_max - 1] + ts_w[0]
    o0 = rnd(torch.nn.functional.silu(x) / n_max) * rnd(v[0, :64])
    assert torch.allclose(got[0][0, :64].detach(), o0.detach(), rtol=1e-5, atol=1e-9)


def test_attention_refuses_a_history_past_max_len():
    lay = ha.make_layout(torch.tensor([5, 9]))
    q = torch.zeros((14, 64))
    with pytest.raises(ValueError, match="max_sequence_length"):
        ha.hstu_attention(q, q, q, torch.zeros(15), torch.zeros(129),
                          torch.zeros(14, dtype=torch.int64), lay, 8)


def test_attention_refuses_fp32_operands_off_the_cpu():
    lay = ha.make_layout(torch.tensor([5, 9]))
    q = torch.zeros((14, 64), device="meta")
    with pytest.raises(ValueError, match="bf16 operands only"):
        ha.hstu_attention(q, q, q, torch.zeros(19, device="meta"),
                          torch.zeros(129, device="meta"),
                          torch.zeros(14, dtype=torch.int64, device="meta"), lay, 10, bf16=False)


def test_attention_refuses_more_than_four_heads_off_the_cpu():
    # a warpgroup a head: the card's path refuses a fifth before any launch
    # (on the CPU the plain version takes any number)
    lay = ha.make_layout(torch.tensor([5, 9]))
    q = torch.zeros((14, (ha.MAX_HEADS + 1) * ha.HEAD_DIM), device="meta")
    with pytest.raises(ValueError, match=f"at most {ha.MAX_HEADS} heads"):
        ha.hstu_attention(q, q, q, torch.zeros(19, device="meta"),
                          torch.zeros(129, device="meta"),
                          torch.zeros(14, dtype=torch.int64, device="meta"), lay, 10)


# ---- row 13: the sampled softmax --------------------------------------------

def test_sampled_softmax_masks_accidental_hits_and_counts_duplicates():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(40, 128, generator=g), dim=1)
    table = torch.nn.functional.normalize(torch.randn(30, 128, generator=g), dim=1)
    pos = torch.randint(0, 30, (40,), generator=g)
    neg = torch.randint(0, 30, (40, 8), generator=g)
    neg[0, :3] = pos[0]
    neg[1, 4] = neg[1, 5]
    q.requires_grad_(True)
    table.requires_grad_(True)
    loss = ss.sampled_softmax(q, table, pos, neg, 0.05)
    got = [loss, *torch.autograd.grad(loss, [q, table])]
    lp = (q * table[pos]).sum(1) / 0.05
    ln = torch.einsum("mkd,md->mk", table[neg], q) / 0.05
    ln = torch.where(neg == pos[:, None], -math.inf, ln)
    want = (torch.logsumexp(torch.cat([lp[:, None], ln], 1), 1) - lp).mean()
    want = [want, *torch.autograd.grad(want, [q, table])]
    for a, b in zip(got, want):
        assert _rel(a, b) <= RTOL
    # row 0 holds 5 negatives: its three hits leave its loss unmoved
    assert torch.isfinite(got[0])


# ---- the model and the trainer ----------------------------------------------

def _draws(lay, model: ModelConfig, seed: int):
    return hstu.draw(torch.Generator().manual_seed(seed), lay, model)


@pytest.mark.parametrize("bf16", [False, True])
def test_one_block_loss_and_gradients_follow_the_reference(bf16):
    m = _model(hstu_blocks=1, hstu_max_len=200, mixed_precision=bf16)
    h = _histories(4, EDGE_LENGTHS)
    lay = ha.make_layout(h["lengths"])
    draws = _draws(lay, m, 5)
    sup = hstu.supervised(lay)
    draws["negatives"][0, :2] = h["items"][sup[0] + 1]  # accidental hits
    p0 = hstu.init(6, m, "cpu")
    params = ref.clone_params(p0)
    leaves = ref.leaves(params)
    loss = hstu.loss(params, m, h["items"], h["timestamps"], lay, draws)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    rparams = ref.clone_params(p0)
    rloss = ref.loss_and_grads(rparams, dataclasses.asdict(m), dict(h, draws=draws),
                               "bf16" if bf16 else "fp32")
    tol = BF16_RTOL if bf16 else RTOL
    assert abs(float(loss) - float(rloss)) <= tol * abs(float(rloss))
    for k, v in ref.leaves(rparams).items():
        assert _rel(grads[k], v.grad) <= tol, k


def _three_steps(tmp_path, seed: int):
    """Three trainer steps -> (the program's readings, the initial params,
    the recorded steps)."""
    m = _model()
    tr = Trainer(_config(m), output_dir=str(tmp_path), device="cpu")
    p0 = hstu.init(seed, m, "cpu")
    state = tr.state_from_params(p0, seed)
    lengths = np.random.default_rng(seed % 2**32).integers(1, 81, 12)
    lengths[:3] = (1, 2, 65)
    h = _histories(seed % 2**32, lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    step = tr.make_train_epoch(None, 4, 1)
    losses, mu1, tr.record_steps = [], None, []
    for s in range(3):
        lo, hi = starts[4 * s], starts[4 * s + 4]
        state, metrics = step(state, {"items": h["items"][lo:hi],
                                      "timestamps": h["timestamps"][lo:hi],
                                      "lengths": h["lengths"][4 * s:4 * s + 4]}, s)
        losses.append(float(metrics["loss"]))
        if s == 0:
            mu1 = {k: v.clone() for k, v in ref.leaves(state.opt_state["mu"]).items()}
            assert float(metrics["events"]) == sum(lengths[:4])
            assert float(metrics["attn_pairs"]) == sum(n * (n + 1) // 2 for n in lengths[:4])
    return ref.program_readings(losses, _tree(mu1), state.params, p0), p0, tr.record_steps


def _follow(p0, steps, fmt: str = "bf16", fault: str = ""):
    return ref.follow_steps(p0, steps, dataclasses.asdict(_model()), {"learning_rate": LR},
                            fmt, fault)


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
def test_three_trainer_steps_follow_the_reference(tmp_path, seed):
    prog, p0, steps = _three_steps(tmp_path, seed)
    ok, checks = compare.judge(compare.train_numbers(prog, _follow(p0, steps)), STEP_LIMITS)
    assert ok, checks


@pytest.mark.parametrize("fmt,fault", [("fp8", ""), ("bf16", "no_time_bias"),
                                       ("bf16", "own_n"), ("bf16", "no_diagonal")])
def test_the_fp8_control_and_the_planted_faults_fail_the_limits(tmp_path, fmt, fault):
    _, p0, steps = _three_steps(tmp_path, 11)
    numbers = compare.train_numbers(_follow(p0, steps, fmt, fault), _follow(p0, steps))
    ok, checks = compare.judge(numbers, STEP_LIMITS)
    assert not ok, checks


def test_the_epoch_trains_every_history_in_whole_batches(tmp_path):
    tr = Trainer(_config(), output_dir=str(tmp_path), device="cpu")
    state = tr.init_state(0, 0, 3)
    lengths = np.random.default_rng(2).integers(1, 81, 10)
    h = _histories(2, lengths)
    epoch = tr.make_train_epoch(None, 10, 2)
    tr.record_steps = []
    state, metrics = epoch(state, h, 0)
    assert state.step == 2 and len(tr.record_steps) == 2 and np.isfinite(float(metrics["loss"]))
    seen = sorted(int(n) for s in tr.record_steps for n in s["lengths"])
    assert len(seen) == 8 and set(seen) <= set(lengths.tolist())


def _bundle(path: str) -> str:
    rng = np.random.default_rng(3)

    def split(n):
        lengths = rng.integers(1, 60, n)
        h = _histories(int(rng.integers(100)), lengths)
        return {k: v.numpy() for k, v in h.items()}

    np.savez(path, **{f"{s}/{k}": v for s, n in (("train", 16), ("val", 6))
                      for k, v in split(n).items()})
    return path


def test_train_cli_trains_hstu_from_a_config(tmp_path):
    from recsys_tpu_torch.train import __main__ as cli

    conf = str(tmp_path / "hstu.json")
    _config().save(conf)
    data = _bundle(str(tmp_path / "bundle.npz"))
    out = tmp_path / "run"
    assert cli.main(["--config", conf, "--data", data, "--device", "cpu",
                     "--output_dir", str(out), "--set", "train.epochs=2"]) == 0
    with open(out / "metrics.json") as f:
        report = json.load(f)
    assert np.isfinite(report["val_loss"]) and report["epochs_run"] == 2
    assert RecsysConfig.load(str(out / "config.json")).model.arch == "hstu"
    assert any((out / "checkpoints").iterdir())


def test_dryrun_takes_hstu_from_its_config(tmp_path, capsys):
    from recsys_tpu_torch.train import dryrun

    conf = str(tmp_path / "hstu.json")
    _config(_model(hstu_items=5000, hstu_max_len=4096)).save(conf)
    assert dryrun.main(["--config", conf, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["events"] > 0 and out["attn_pairs"] >= out["events"]


# ---- the reference stands alone ---------------------------------------------

@pytest.mark.parametrize("path", ["tests/reference/hstu.py", "bench_port/reference/hstu.py"])
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
