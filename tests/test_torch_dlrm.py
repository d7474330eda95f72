"""DLRM-DCNv2 in the port (``models/dlrm.py``, ``ops/embedding_bag.py``'s
plain versions, the low-rank cross, row-wise Adagrad, ``Trainer`` and the
train CLI) against the plain reference (``tests/reference/dlrm_dcnv2.py``)
on seeded random weights, at a small size on the CPU: 5 tables of 3 to
2,000 rows (the 3-row table hit by every example), bags of 1 to 7 ids with
duplicates, D = 16, rank 8, B = 64. The kernels themselves run only on the
card: ``chip_smoke.py --dlrm-bags`` holds them to these plain versions
there, at the benchmark cell's shape.

Tolerances, each with its reason:

* the bags' forward is the reference's sum bit for bit (the same fp32 adds
  in the same order);
* a row's update, the cross and the steps differ from the reference by the
  order of fp32 sums alone (a row's lookups summed by column against in
  one pass; the batch permuted by the epoch): 1e-6 relative to the largest
  value for single ops, and for three whole steps the benchmark's own
  numbers (``bench_port/compare.py``) under ``STEP_LIMITS``, which a run
  with the bf16 operands rounded to fp8 instead fails.
"""

import ast
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from bench_port import compare, dlrm_datagen
from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.models import dcn, dlrm
from recsys_tpu_torch.ops import embedding_bag as eb
from recsys_tpu_torch.train import optimizer as opt
from recsys_tpu_torch.train.trainer import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location(
    "dlrm_dcnv2_reference", os.path.join(HERE, "reference", "dlrm_dcnv2.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

TABLE_ROWS = (3, 50, 2000, 7, 311)
BAG_SIZES = (1, 3, 7, 2, 5)
D, RANK, B = 16, 8, 64
LR = float(np.float32(0.004))
# three steps against the reference: the loss relative, each leaf's first
# gradient (from its slot) and its change after 3 steps against the larger
# of its and the median leaf's norm. Over 10 seeds the sound runs read at
# most 2.0e-5 / 1.0e-6 / 6.7e-5 (a bf16 rounding of an activation or a
# gradient that falls the other way once the batch's sums run in another
# order), the fp8 control at least 1.2e-3 / 3.8e-2 / 1.6e-2
STEP_LIMITS = {"loss_gap": 2e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
SINGLE_OP_RTOL = 1e-6


def _model(**kw) -> ModelConfig:
    base = dict(arch="dlrm_dcnv2", embedding_dim=D, table_rows=TABLE_ROWS, bag_sizes=BAG_SIZES,
                table_init_rows=TABLE_ROWS, bottom_mlp_dims=(32, D), over_arch_dims=(32, 16),
                dcn_low_rank_dim=RANK, cross_layers=2, dropout_rate=0.0)
    return ModelConfig(**{**base, **kw})


def _model_dict(model: ModelConfig) -> dict:
    return dataclasses.asdict(model)


def _config(model=None, **train) -> RecsysConfig:
    t = dict(batch_size=B, learning_rate=0.004, lr_decay_rate=1.0, clipnorm=0.0,
             async_checkpoint=False, epochs=2)
    return RecsysConfig(model=model or _model(), train=TrainConfig(**{**t, **train}))


def _ids(seed: int, b: int = B, duplicates: bool = True) -> torch.Tensor:
    """[b, S] int32 ids; with ``duplicates`` every bag of more than one id
    repeats its first id in its last column."""
    rng = np.random.default_rng(seed)
    cols = []
    for rows, h in zip(TABLE_ROWS, BAG_SIZES):
        bag = rng.integers(0, rows, (b, h))
        if duplicates and h > 1:
            bag[:, -1] = bag[:, 0]
        cols.append(bag)
    return torch.as_tensor(np.concatenate(cols, axis=1).astype(np.int32))


def _layout():
    return eb.make_layout(TABLE_ROWS, BAG_SIZES, "cpu")


def _table(seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((sum(TABLE_ROWS), D), generator=g) - 0.5


def _dense_table_grad(ids: torch.Tensor, bag_grad: torch.Tensor) -> torch.Tensor:
    """The reference's [rows, D] table gradient: each lookup's bag gradient
    added at its row."""
    g = torch.zeros((sum(TABLE_ROWS), D))
    c, off = 0, 0
    for t, (rows, h) in enumerate(zip(TABLE_ROWS, BAG_SIZES)):
        for j in range(h):
            g.index_add_(0, off + ids[:, c + j].long(), bag_grad[:, t])
        c += h
        off += rows
    return g


# ---- the configuration ------------------------------------------------------

def test_config_file_holds_the_published_widths_and_bags():
    with open(os.path.join(REPO, "bench_port", "configs", "mlperf-dlrm-dcnv2-1of8.json")) as f:
        c = json.load(f)
    pub, m = c["published"], c["model"]
    assert pub["num_embeddings_per_feature"] == [
        40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956, 405282, 10,
        2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36]
    assert pub["multi_hot_sizes"] == m["bag_sizes"] == [
        3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1]
    assert sum(m["bag_sizes"]) == 214
    # every table held whole but the five 40M-row ones, an eighth of each
    assert m["table_rows"] == [r // 8 if r == 40_000_000 else r
                               for r in pub["num_embeddings_per_feature"]]
    assert sum(m["table_rows"]) == 29_184_588 and sum(pub["num_embeddings_per_feature"]) == 204_184_588
    assert m["table_init_rows"] == pub["num_embeddings_per_feature"]
    assert c["reduced"] == ["num_embeddings_per_feature"]
    assert (m["embedding_dim"], m["dlrm_dense_in"], m["cross_layers"], m["dcn_low_rank_dim"]) == (
        pub["embedding_dim"], pub["num_dense_features"], pub["dcn_num_layers"],
        pub["dcn_low_rank_dim"]) == (128, 13, 3, 512)
    assert m["bottom_mlp_dims"] == pub["dense_arch_layer_sizes"] == [512, 256, 128]
    assert m["over_arch_dims"] + [1] == pub["over_arch_layer_sizes"] == [1024, 1024, 512, 256, 1]
    assert c["train"]["learning_rate"] == pub["learning_rate"] == 0.004
    assert all(isinstance(v, str) and v for v in c["assumed"].values())
    cfg = RecsysConfig.load(os.path.join(REPO, "bench_port", "configs",
                                         "mlperf-dlrm-dcnv2-1of8.json"))
    assert cfg.model.arch == "dlrm_dcnv2" and dlrm.input_dim(cfg.model) == 3456


def test_two_tower_config_json_keeps_the_jax_layout_and_dlrm_round_trips():
    assert "arch" not in RecsysConfig().to_dict()["model"]
    cfg = _config()
    back = RecsysConfig.from_json(cfg.to_json())
    assert back == cfg and back.model.table_rows == TABLE_ROWS
    assert RecsysConfig().replace(**{"model.arch": "dlrm_dcnv2", "model.table_rows": [3],
                                     "model.bag_sizes": [1], "model.embedding_dim": 128}
                                  ).model.arch == "dlrm_dcnv2"


@pytest.mark.parametrize("bad", [dict(arch="dlrm"), dict(bag_sizes=(1,)),
                                 dict(bottom_mlp_dims=(32, 8))])
def test_model_config_refuses_an_inconsistent_dlrm(bad):
    with pytest.raises(ValueError):
        _model(**bad)


@pytest.mark.parametrize("train", [dict(clipnorm=1.0), dict(optimizer="adam"),
                                   dict(negative_cache=64)])
def test_dlrm_trainer_refuses_the_modes_it_does_not_train_in(tmp_path, train):
    with pytest.raises(ValueError, match="dlrm_dcnv2"):
        Trainer(_config(**train), output_dir=str(tmp_path), device="cpu")


# ---- the bags ---------------------------------------------------------------

def test_layout_places_each_table_and_clamps_ids():
    lay = _layout()
    assert lay.n_rows == sum(TABLE_ROWS) and lay.bag_start.tolist()[-1] == sum(BAG_SIZES)
    assert lay.row_offset.tolist() == [0, 3, 53, 2053, 2060]
    ids = torch.full((1, sum(BAG_SIZES)), 10**6, dtype=torch.int32)
    rows = eb.global_rows(ids, lay)[0].tolist()
    assert rows[0] == 2 and rows[-1] == sum(TABLE_ROWS) - 1  # each id clamped to its table


@pytest.mark.parametrize("case", ["uniform", "duplicates", "one_row"])
def test_bag_forward_is_the_reference_sum(case):
    ids = _ids(1, duplicates=case != "uniform")
    if case == "one_row":
        ids = torch.zeros_like(ids)  # every lookup of every table hits its row 0
    table = _table(2)
    got = eb.bag_forward(table, ids, _layout())
    want = ref.bags(table, ids, TABLE_ROWS, BAG_SIZES)
    assert got.shape == (B, len(TABLE_ROWS), D) and torch.equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_bag_backward_with_rowwise_adagrad_follows_the_reference(seed):
    """The looked-up rows and their accumulators after one update, against
    the reference's row-wise Adagrad over its dense table gradient; the
    3-row table takes all B of its lookups on 3 rows."""
    ids, table = _ids(seed), _table(seed)
    g = torch.Generator().manual_seed(seed)
    bag_grad = torch.randn((B, len(TABLE_ROWS), D), generator=g)
    accum = torch.rand((sum(TABLE_ROWS),), generator=g)
    t, a = table.clone(), accum.clone()
    lookups, unique = eb.bag_backward_rowwise_adagrad(t, a, ids, bag_grad, _layout(), LR)
    want_t, want_a = table.clone(), accum.clone()
    ref.adagrad_steps({"embedding": {"table": want_t}}, {}, want_a, {},
                      _dense_table_grad(ids, bag_grad), LR)
    assert float(lookups) == ids.numel()
    assert float(unique) == len(torch.unique(eb.global_rows(ids, _layout())))
    torch.testing.assert_close(t, want_t, rtol=SINGLE_OP_RTOL, atol=SINGLE_OP_RTOL * LR)
    torch.testing.assert_close(a, want_a, rtol=SINGLE_OP_RTOL, atol=0.0)
    assert not torch.equal(t, table)


def test_bag_backward_twice_gives_the_same_bits():
    ids, table = _ids(5), _table(5)
    bag_grad = torch.randn((B, len(TABLE_ROWS), D), generator=torch.Generator().manual_seed(5))
    runs = []
    for _ in range(2):
        t, a = table.clone(), torch.zeros(sum(TABLE_ROWS))
        eb.bag_backward_rowwise_adagrad(t, a, ids, bag_grad, _layout(), LR)
        runs.append((t, a))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_rowwise_adagrad_matches_the_reference_and_leaves_other_rows():
    g = torch.Generator().manual_seed(6)
    table, accum = torch.randn((40, D), generator=g), torch.rand((40,), generator=g)
    slot_ids = torch.tensor([2, 5, 9, 31, 0, 0])
    valid = torch.tensor([True, True, True, True, False, False])
    combined = torch.randn((6, D), generator=g)
    combined[2] = 0.0  # a touched row with a zero gradient stays
    t, a = table.clone(), accum.clone()
    opt.sparse_rowwise_adagrad_combined(t, a, slot_ids, combined, valid, LR)
    dense = torch.zeros((40, D))
    dense[slot_ids[:4]] = combined[:4]
    want_t, want_a = table.clone(), accum.clone()
    ref.adagrad_steps({"embedding": {"table": want_t}}, {}, want_a, {}, dense, LR)
    torch.testing.assert_close(t, want_t, rtol=SINGLE_OP_RTOL, atol=0.0)
    torch.testing.assert_close(a, want_a, rtol=SINGLE_OP_RTOL, atol=0.0)
    untouched = torch.ones(40, dtype=torch.bool)
    untouched[[2, 5, 31]] = False
    assert torch.equal(t[untouched], table[untouched])


# ---- the low-rank cross -----------------------------------------------------

@pytest.mark.parametrize("bf16", [True, False])
def test_low_rank_cross_forward_and_backward_follow_the_reference(bf16):
    f = 6 * D
    g = torch.Generator().manual_seed(7)
    params = dcn.init_low_rank_cross(g, 3, f, RANK, "cpu")
    for p in params.values():
        p["b"] += 0.1 * torch.randn(p["b"].shape, generator=g)
    x0 = torch.randn((B, f), generator=g)
    cot = torch.randn((B, f), generator=g)
    outs = []
    for fn in (lambda p, x: dcn.low_rank_cross_stack(p, x, bf16),
               lambda p, x: ref.cross(p, x, "bf16" if bf16 else "fp32")):
        p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in params.items()}
        x = x0.clone().requires_grad_(True)
        y = fn(p, x)
        y.backward(cot)
        outs.append([y.detach(), x.grad] + [t.grad for v in p.values() for t in v.values()])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=SINGLE_OP_RTOL,
                                   atol=SINGLE_OP_RTOL * float(want.abs().max()))


# ---- three steps through the trainer -----------------------------------------

def _three_steps(seed: int, out: str):
    """The program's three steps through ``make_train_epoch`` (one batch
    each) and the inputs the reference follows -> (program readings,
    (p0, batches))."""
    model = _model()
    md = _model_dict(model)
    data = dlrm_datagen.batches(seed, {"model": md, "data": {"first_id_zipf": 1.0,
                                                             "positive_rate": 0.2}},
                                3 * B, "cpu")
    batches = [{k: v[s * B:(s + 1) * B] for k, v in data.items()} for s in range(3)]
    p0 = dlrm_datagen.weights(seed, md, "cpu")
    trainer = Trainer(_config(model), output_dir=out, device="cpu")
    dense0 = {p: v.clone() for p, v in ref.dense_leaves(p0)}
    state = trainer.state_from_params(p0, seed)  # the table is taken, not copied
    step = trainer.make_train_epoch(None, B, 1)
    prog = {"loss": []}
    for s, batch in enumerate(batches):
        state, m = step(state, batch, s)
        prog["loss"].append(float(m["loss"]))
        if s == 0:
            accum = state.opt_state["accum"]
            prog["grad_norm"] = ref.slot_norms(accum, accum["embedding"]["table"], md)
    table0 = lambda t: dlrm_datagen.initial_table(seed, md, t, "cpu")  # noqa: E731
    prog["change_norm"] = ref.change_norms(state.params, dense0, table0, md)
    return prog, (md, batches, table0)


def _reference(seed: int, md, batches, table0, fmt: str):
    return ref.follow_steps(dlrm_datagen.weights(seed, md, "cpu"), batches, md,
                            {"learning_rate": 0.004}, table0, fmt=fmt, rows=24)


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_three_trainer_steps_follow_the_reference(seed, tmp_path):
    prog, (md, batches, table0) = _three_steps(seed, str(tmp_path))
    want = _reference(seed, md, batches, table0, "bf16")
    ok, checks = compare.judge(compare.train_numbers(prog, want), STEP_LIMITS)
    assert ok, checks
    assert prog["loss"][2] < prog["loss"][0]


def test_fp8_operands_fail_the_step_tolerances(tmp_path):
    """The same steps with the bf16 operands rounded to fp8 (e4m3) read
    above one of ``STEP_LIMITS``: the comparison can tell the stated
    precision from the next one below it."""
    seed = 11
    _, (md, batches, table0) = _three_steps(seed, str(tmp_path))
    bf16 = _reference(seed, md, batches, table0, "bf16")
    fp8 = _reference(seed, md, batches, table0, "fp8")
    ok, checks = compare.judge(compare.train_numbers(fp8, bf16), STEP_LIMITS)
    assert not ok, checks


# ---- the CLIs ---------------------------------------------------------------

def _bundle(path: str) -> str:
    rng = np.random.default_rng(0)

    def split(n):
        sparse = np.concatenate([rng.integers(0, r, (n, h)) for r, h in
                                 zip(TABLE_ROWS, BAG_SIZES)], axis=1).astype(np.int32)
        return {"dense": rng.random((n, 13), dtype=np.float32), "sparse": sparse,
                "label": (rng.random(n) < 0.3).astype(np.float32)}

    np.savez(path, **{f"{s}/{k}": v for s, n in (("train", 4 * B), ("val", 100))
                      for k, v in split(n).items()})
    return path


def test_train_cli_trains_dlrm_from_a_config(tmp_path):
    from recsys_tpu_torch.train import __main__ as cli

    conf = str(tmp_path / "dlrm.json")
    _config().save(conf)
    data = _bundle(str(tmp_path / "bundle.npz"))
    out = tmp_path / "run"
    assert cli.main(["--config", conf, "--data", data, "--device", "cpu",
                     "--output_dir", str(out), "--set", "train.epochs=2"]) == 0
    with open(out / "metrics.json") as f:
        report = json.load(f)
    assert np.isfinite(report["val_loss"]) and report["epochs_run"] == 2
    assert RecsysConfig.load(str(out / "config.json")).model.arch == "dlrm_dcnv2"
    assert any((out / "checkpoints").iterdir())


def test_train_cli_config_refuses_config_flags_beside_it(tmp_path):
    from recsys_tpu_torch.train import __main__ as cli

    conf = str(tmp_path / "dlrm.json")
    _config().save(conf)
    args = cli.build_parser().parse_args(["--config", conf, "--epochs", "3"])
    with pytest.raises(ValueError, match="epochs"):
        cli.build_config(args)
    args = cli.build_parser().parse_args(["--config", conf, "--set", "train.epochs=3"])
    assert cli.build_config(args).train.epochs == 3


def test_dryrun_takes_dlrm_from_its_config(tmp_path, capsys):
    from recsys_tpu_torch.train import dryrun

    conf = str(tmp_path / "dlrm.json")
    _config(model=_model(table_rows=(3, 50, 5000, 7, 311))).save(conf)
    assert dryrun.main(["--config", conf, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["lookups"] == 8 * sum(BAG_SIZES)


# ---- the reference stands alone ---------------------------------------------

@pytest.mark.parametrize("path", ["tests/reference/dlrm_dcnv2.py",
                                  "bench_port/reference/dlrm.py"])
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
