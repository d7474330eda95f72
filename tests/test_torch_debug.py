"""The port's debugging modes and metric sinks against the JAX package's,
on the CPU: ``debug_nans`` (the NaN switch of ``utils/debug.py``, each
kernel wrapper's check on its plain branch, the train step's check and the
naming re-run, bit-equality without a NaN, two gloo ranks under a mesh),
``profile`` under a 2-rank mesh, and the TensorBoard and W&B sinks
(``MetricWriter`` and the train CLI's ``--use_wandb``).

The mesh cases run in ``tests/torch_debug_worker.py``: 2 gloo ranks started
by ``subprocess`` on a ``FileStore`` under ``tmp_path``,
``OMP_NUM_THREADS=1``, the join bounded at ``JOIN_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from recsys_tpu.utils.metrics_io import MetricWriter as JaxMetricWriter
from scripts import train as jax_cli
from recsys_tpu_torch.config import EvalConfig, ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.ops import dcn_cross as dcn_mod
from recsys_tpu_torch.ops import flash_ce as flash_mod
from recsys_tpu_torch.ops import topk_flash as topk_mod
from recsys_tpu_torch.train import __main__ as cli
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer
from recsys_tpu_torch.utils import debug
from recsys_tpu_torch.utils.metrics_io import MetricWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 180
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(16,), item_tower_dims=(16,),
                cross_layers=2, dnn_dims=(16,))


@pytest.fixture
def nan_checks():
    """The switch on for the test, off after it whatever happens."""
    debug.enable_nan_checks()
    try:
        yield
    finally:
        debug.disable_nan_checks()


def _port_cfg(**train_kw):
    return RecsysConfig(model=ModelConfig(**MODEL_KW, dropout_rate=0.2),
                        train=TrainConfig(**{"batch_size": 256, "epochs": 1, **train_kw}),
                        eval=EvalConfig(topk=(10,), eval_sample=50))


def _nan_ratings(bundle):
    b = dict(bundle)
    r = b["train/rating"].copy()
    r[::10] = np.nan  # every batch holds some
    b["train/rating"] = r
    return b


# ---- the kernel wrappers' check -------------------------------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    u, v = torch.randn(8, 16, generator=g), torch.randn(12, 16, generator=g)
    ids = torch.arange(12, dtype=torch.int32)
    flash = (u, v, torch.zeros(12), ids[:8], ids, ids[:8])
    bwd = flash + (torch.full((8,), 3.0), torch.ones(8))
    x0, w, b = torch.randn(8, 16, generator=g), torch.randn(2, 16, generator=g), torch.zeros(2, 16)
    resid = torch.stack([x0, x0])
    return {
        1: (topk_mod.flash_topk, (u, v, 5), 0),
        2: (dcn_mod.dcn_cross, (x0, w, b), 1),
        3: (dcn_mod.dcn_cross_bwd, (x0, w, resid, torch.ones(8, 16)), 1),
        4: (flash_mod.flash_ce_fwd, flash, 0),
        5: (flash_mod.flash_ce_bwd_fused, bwd, 0),
        6: (flash_mod.flash_ce_bwd_du, bwd, 1),
        7: (flash_mod.flash_ce_bwd_dv, bwd, 0),
        8: (topk_mod.blockmax_group_max, (u, v, 4), 0),
    }


@pytest.mark.parametrize("row", range(1, 9))
def test_kernel_wrappers_name_their_row_on_the_plain_branch(row, nan_checks):
    """A NaN in an input comes out of each wrapper's plain (CPU) branch: with
    the switch on it raises ``FloatingPointError`` naming the kernel's row;
    inside ``deferred_nan_checks`` (a train step's single check) and with
    the switch off it returns the NaN unchecked."""
    fn, args, poisoned = _kernel_cases()[row]
    args = list(args)
    args[poisoned] = args[poisoned].clone()
    args[poisoned][0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=rf"invalid value \(nan\) encountered in kernel row {row} "):
        fn(*args)
    with debug.deferred_nan_checks():
        fn(*args)
    debug.disable_nan_checks()
    fn(*args)


# ---- the train step --------------------------------------------------------

def _batches(n_steps=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"user_id": torch.from_numpy(rng.integers(0, 30, 64).astype(np.int32)),
             "movie_id": torch.from_numpy(rng.integers(0, 40, 64).astype(np.int32)),
             "rating": torch.from_numpy(rng.uniform(1, 5, 64).astype(np.float32)),
             "y_implicit": torch.from_numpy((rng.random(64) > 0.5).astype(np.float32))}
            for _ in range(n_steps)]


@pytest.mark.parametrize("sparse", [False, True])
def test_debug_nans_changes_no_result(sparse, tmp_path):
    """3 steps (dropout on) from one init with the checks on and off: the
    params, slots and losses are bit-equal."""
    out = []
    for on in (False, True):
        if on:
            debug.enable_nan_checks()
        try:
            tr = Trainer(_port_cfg(batch_size=64, sparse_table_updates=sparse),
                         str(tmp_path / str(on)), device="cpu")
            state = tr.init_state(30, 40, 0)
            step = tr.make_train_step((1.2, 0.8))
            losses = []
            for b in _batches():
                state, m = step(state, b)
                losses.append(m["loss"])
        finally:
            debug.disable_nan_checks()
        assert tr.step_counts["sparse" if sparse else "dense"] == 3
        out.append((state, torch.stack(losses)))
    (a, la), (b, lb) = out
    assert torch.equal(la, lb)
    for tree in ("params", "opt_state"):
        got = dict(leaves_with_paths(getattr(b, tree)))
        for path, want in leaves_with_paths(getattr(a, tree)):
            assert torch.equal(got[path], want), (tree, path)


_PLANTED = {
    # a NaN in the first cross layer's w: the cross stack's kernel (its
    # plain version on the CPU) is the first to compute with it
    "cross_w": ("kernel row 2 dcn_cross",
                lambda p, b: p["dcn"]["cross"]["layer_0"]["w"].__setitem__(3, float("nan"))),
    # a NaN in one rating of the batch: the MSE's subtraction
    "rating": ("aten.sub.Tensor", lambda p, b: b["rating"].__setitem__(5, float("nan"))),
}


@pytest.mark.parametrize("case", sorted(_PLANTED))
def test_debug_nans_names_the_op_and_leaves_the_state(case, tmp_path, nan_checks):
    """A planted NaN raises ``FloatingPointError`` at step 0 naming what
    first computed with it, and the step updates nothing."""
    want, plant = _PLANTED[case]
    tr = Trainer(_port_cfg(batch_size=64), str(tmp_path), device="cpu")
    state = tr.init_state(30, 40, 0)
    batch = _batches(1)[0]
    with torch.no_grad():
        plant(state.params, batch)
    before = {p: t.clone() for p, t in leaves_with_paths(state.params)}
    slots = {p: t.clone() for p, t in leaves_with_paths(state.opt_state)}
    with pytest.raises(FloatingPointError) as e:
        tr.make_train_step((1.0, 1.0))(state, batch)
    assert str(e.value).startswith(f"invalid value (nan) encountered in {want}")
    assert str(e.value).endswith("at step 0")
    for path, t in leaves_with_paths(state.params):
        torch.testing.assert_close(t, before[path], rtol=0, atol=0, equal_nan=True)
    for path, t in leaves_with_paths(state.opt_state):
        assert torch.equal(t, slots[path]), path


def test_debug_nans_in_train_writes_no_checkpoint(tiny_bundle, tmp_path, monkeypatch):
    """``Trainer.train`` with a NaN in a cross weight raises naming row 2 and
    saves no checkpoint (the switch is the trainer's to turn on)."""
    init_state = Trainer.init_state

    def planted(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        with torch.no_grad():
            state.params["dcn"]["cross"]["layer_0"]["w"][0] = float("nan")
        return state

    monkeypatch.setattr(Trainer, "init_state", planted)
    out = tmp_path / "run"
    try:
        with pytest.raises(FloatingPointError, match="kernel row 2 dcn_cross"):
            Trainer(_port_cfg(debug_nans=True), str(out), device="cpu").train(tiny_bundle)
        assert debug.nan_checks_enabled()
    finally:
        debug.disable_nan_checks()
    assert os.listdir(out / "checkpoints") == []


def test_debug_nans_raises_at_the_first_step_as_jax(tiny_bundle, tmp_path):
    """The same bundle with NaN ratings in the train split: JAX's
    ``Trainer(debug_nans=True).train`` (``jax_debug_nans``) raises
    ``FloatingPointError`` in the first epoch's step scan, the port's at
    step 0 naming the op; neither writes a checkpoint."""
    bundle = _nan_ratings(tiny_bundle)
    jcfg = JaxRecsysConfig(
        model=JaxModelConfig(**MODEL_KW, use_pallas_dcn=True),
        train=JaxTrainConfig(batch_size=256, epochs=1, debug_nans=True),
        eval=JaxEvalConfig(topk=(10,)))
    try:
        with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in"):
            JaxTrainer(jcfg, str(tmp_path / "jax"),
                       mesh_ctx=make_mesh(devices=jax.devices()[:1])).train(bundle)
    finally:
        jax.config.update("jax_debug_nans", False)  # JAX never turns it off
    try:
        with pytest.raises(FloatingPointError,
                           match=r"invalid value \(nan\) encountered in aten\..* at step 0$"):
            Trainer(_port_cfg(debug_nans=True), str(tmp_path / "port"),
                    device="cpu").train(bundle)
    finally:
        debug.disable_nan_checks()
    for side in ("jax", "port"):
        assert os.listdir(tmp_path / side / "checkpoints") == [], side


# ---- under a mesh: 2 gloo ranks ---------------------------------------------

@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory, tiny_bundle):
    root = tmp_path_factory.mktemp("torch_debug")
    np.savez(root / "bundle.npz", **tiny_bundle)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_debug_worker.py"),
                               str(r), "2", str(root / "store"), str(root / "bundle.npz"),
                               str(root)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, o=o: o.append(p.stdout.read()), daemon=True)
               for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for t in readers:
            t.join(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], "\n".join("".join(o)[-3000:] for o in outs)
    return root, [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]


def test_debug_nans_under_a_mesh_every_rank_raises_at_one_step(mesh_world):
    """A NaN in model rank 1's user shard only (row-sharded tables, psum):
    in padding no batch reads, only rank 1's params after the update of step
    0 hold it, and both ranks raise for that step (rank 0 naming rank 1);
    in every row of the shard, the loss of step 0 on both ranks, which
    re-run the step together (collectives and all) and raise. No rank
    hangs: the worlds end within the join's bound."""
    _, ranks = mesh_world
    upd = [r["nan_update"] for r in ranks]
    assert upd[1] == ("FloatingPointError: invalid value (nan) encountered in params "
                      "towers/user_table after the adagrad update of step 0 at step 0")
    assert upd[0] == ("FloatingPointError: invalid value (nan) encountered in rank 1's step "
                      "at step 0")
    for r in ranks:
        msg = r["nan_loss"]
        assert msg.startswith("FloatingPointError: invalid value (nan) encountered in ")
        assert msg.endswith(" at step 0"), msg


def test_profile_under_a_mesh_only_rank_0_traces(mesh_world):
    """``train.profile`` on the 2-rank data-parallel mesh: one parsable
    trace under ``<output_dir>/profile``, written by rank 0's process."""
    root, ranks = mesh_world
    traces = list((root / "profile_run" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert traces[0].name.split(".")[0].endswith(f"_{ranks[0]['pid']}")
    assert json.loads(traces[0].read_text())["traceEvents"]


# ---- the sinks ---------------------------------------------------------------

def _scalars(tb_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(tmp_path):
    """Both packages' ``MetricWriter``s fed the same three epochs' logs write
    TensorBoard event files with the same tags and steps, and the same
    values for the logged keys (the writers' own timing and memory keys
    differ between processes)."""
    rng = np.random.default_rng(0)
    logs = [{"train_loss": float(rng.random()), "val_loss": float(rng.random()),
             "examples_per_s": float(rng.random() * 1e4)} for _ in range(3)]
    writers = {"port": MetricWriter(str(tmp_path / "port")),
               "jax": JaxMetricWriter(str(tmp_path / "jax"))}
    for w in writers.values():
        for epoch, entry in enumerate(logs):
            w.start_epoch()
            w.end_epoch(epoch, entry)
        w.close()
    got, want = (_scalars(tmp_path / side / "tensorboard") for side in ("port", "jax"))
    assert sorted(got) == sorted(want) and set(logs[0]) <= set(got)
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [0, 1, 2]
        if tag in logs[0]:
            assert got[tag] == want[tag]
            assert [v for _, v in got[tag]] == pytest.approx([e[tag] for e in logs])


class _FakeWandb(types.ModuleType):
    """``wandb`` as the two CLIs use it, recording the calls."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        self.run = None

    def init(self, project=None, config=None):
        self.calls.append(("init", project, json.loads(json.dumps(config))))
        self.run = types.SimpleNamespace(
            log=lambda data, step=None: self.calls.append(("log", sorted(data), step)),
            finish=lambda: self.calls.append(("finish",)))
        return self.run


def test_use_wandb_makes_the_jax_cli_calls(tiny_bundle, tmp_path, monkeypatch):
    """``--use_wandb`` through the port's CLI and ``scripts/train.py``'s
    ``main`` on one bundle and argv: the same ``init`` project and config,
    per-epoch keys and steps, ``final/`` keys and ``finish`` (the values
    are not compared)."""
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    argv = ["--data", data, "--embedding_dim", "16", "--cross_layers", "1", "--batch_size",
            "256", "--epochs", "2", "--no-bf16", "--eval_sample", "50", "--use_wandb",
            "--set", "model.user_tower_dims=[16]", "--set", "model.item_tower_dims=[16]",
            "--set", "model.use_pallas_dcn=true", "--set", "eval.topk=[10]"]
    calls = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        assert main(argv + extra + ["--output_dir", str(tmp_path / side)]) == 0
        calls[side] = fake.calls
    assert calls["port"] == calls["jax"]
    kinds = [c[0] for c in calls["port"]]
    assert kinds == ["init", "log", "log", "log", "finish"]
    assert calls["port"][0][1] == "recsys-tpu"
    assert [c[2] for c in calls["port"][1:3]] == [0, 1]
    assert all(k.startswith("final/") for k in calls["port"][3][1])
