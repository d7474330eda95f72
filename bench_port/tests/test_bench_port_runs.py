"""Whole runs of tiny cells on the CPU, past the harness's look for a
card: the harness finds what files add, a stall inside the window moves
the end-to-end metrics, and ``correct`` comes out false when the timed
path is broken underneath, once for each fault a cell can have (one card:
no exchange between chips to leave out). The control and the faults
planted in the reference read above every cell's limits."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_port import control, harness

TRAIN = ["scale-train-cbns"]
SERVE = ["ml1m-serve-poisson"]


def test_a_new_cell_config_and_metric_are_found_by_their_files(tiny_root, run_tiny):
    cfg_dir, wl_dir = os.path.join(tiny_root, "configs"), os.path.join(tiny_root, "workloads")
    with open(os.path.join(cfg_dir, "ml1m-twotower-dcn.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-wide"
    cfg["model"]["embedding_dim"] = 12
    with open(os.path.join(cfg_dir, "tiny-wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(wl_dir, "scale-train-cbns.json")) as f:
        cell = json.load(f)
    cell.update(name="tiny-wide-train", config="tiny-wide")
    with open(os.path.join(wl_dir, "tiny-wide-train.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(tiny_root, "layer_metrics", "train.steps_seen.py"), "w") as f:
        f.write("def read(res, ctx):\n    return float(res['stats']['steps'])\n")
    bench_path = os.path.join(os.path.dirname(tiny_root), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-wide-train", "config": "tiny-wide",
                               "traffic": "train-wide", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_examples_per_s" in (m["name"], m.get("moves")):
            m["workloads"] = m["workloads"] + ["tiny-wide-train"]
    bench["per_layer"].append({"name": "train.steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_examples_per_s",
                               "workloads": ["tiny-wide-train"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    out = run_tiny("tiny-wide-train", trace=True)
    assert out["correct"]
    assert out["metrics"]["train.steps_seen"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) >= {"mfu.train", "train.steps_seen"}
    out = run_tiny("tiny-wide-train")
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(run_tiny, cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0


def test_a_stall_in_the_window_moves_recommend_p95(run_tiny, monkeypatch):
    base = run_tiny("ml1m-serve-poisson", seconds=2.0)["metrics"]["recommend_p95_ms"]["value"]
    from recsys_tpu_torch.serve.service import RecommendationService

    real = RecommendationService.recommend_batch
    calls = []

    def stalled(self, user_ids, k=10):
        calls.append(1)
        if len(calls) == 4 + 30:  # past the warm-up, inside the window
            time.sleep(0.6)
        return real(self, user_ids, k)

    monkeypatch.setattr(RecommendationService, "recommend_batch", stalled)
    out = run_tiny("ml1m-serve-poisson", seconds=2.0)
    # every request due during the stall waits for it: the tail grows by most of it
    assert out["metrics"]["recommend_p95_ms"]["value"] > base + 200
    assert out["correct"]


def test_a_stall_in_the_window_moves_train_examples_per_s(run_tiny, monkeypatch):
    base = run_tiny("scale-train-cbns")["metrics"]["train_examples_per_s"]["value"]
    from recsys_tpu_torch.train.trainer import Trainer

    real = Trainer.make_train_epoch

    def stalled_epoch(self, cw, n_rows, n_steps, use_explicit_negs=False):
        fn = real(self, cw, n_rows, n_steps, use_explicit_negs)

        def epoch(state, data, epoch):
            time.sleep(0.2)
            return fn(state, data, epoch)

        return epoch

    monkeypatch.setattr(Trainer, "make_train_epoch", stalled_epoch)
    out = run_tiny("scale-train-cbns")
    assert out["metrics"]["train_examples_per_s"]["value"] < 0.8 * base


def _break_step(monkeypatch, how):
    from recsys_tpu_torch.train.trainer import Trainer

    real = Trainer._step_core

    def broken(self, *a, **kw):
        step = real(self, *a, **kw)

        def unchanged(state, batch):
            saved = [(p, p.detach().clone()) for p in _tensors(state.params)]
            saved += [(p, p.detach().clone()) for p in _tensors(state.opt_state)]
            new, metrics = step(state, batch)
            with torch.no_grad():
                for p, v in saved:
                    p.copy_(v)
            return new, metrics

        def half(state, batch):
            b = batch["user_id"].shape[0] // 2
            return step(state, {k: v[:b] for k, v in batch.items()})

        return {"unchanged": unchanged, "half": half}[how]

    monkeypatch.setattr(Trainer, "_step_core", broken)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_step_is_not_correct(run_tiny, monkeypatch, cell, fault):
    _break_step(monkeypatch, fault)
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_not_correct(run_tiny, monkeypatch, cell):
    from recsys_tpu_torch.serve.service import RecommendationService

    real = RecommendationService.recommend_batch

    def altered(self, user_ids, k=10):
        rows = real(self, user_ids, k)
        for row in rows:
            recs = row["recommendations"]
            recs[0] = dict(recs[0], item_id=1 + (recs[0]["item_id"] % 50))  # another item
        return rows

    monkeypatch.setattr(RecommendationService, "recommend_batch", altered)
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_the_control_and_the_planted_faults_fail_the_limits(tiny_root, monkeypatch, capsys,
                                                            cell):
    monkeypatch.setattr(harness, "HERE", tiny_root)
    real_cell, real_driver = harness.load_cell, harness.load_driver
    monkeypatch.setattr(harness, "load_cell", lambda n, root=tiny_root: real_cell(n, root))
    monkeypatch.setattr(harness, "load_driver", lambda n, root=tiny_root: real_driver(n, root))
    control.main(["--workload", cell, "--seeds", "17", "18", "--device", "cpu",
                  "--seconds", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2
    for line in lines:
        limits = line["limits"]
        for reading in [k for k in line if k.startswith(("control", "fault"))]:
            nums = line[reading]
            assert any(nums[n] > lim for n, lim in limits.items()), (reading, nums, limits)
        assert all(line["self"][n] <= lim for n, lim in limits.items())


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, os.path.join(repo, "bench_port", "run.py"),
                        "--workload", "ml1m-serve-poisson", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_each_cell_runs_correct_on_the_card(card, cell):
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, os.path.join(repo, "bench_port", "run.py"),
                        "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
