"""Tests of the benchmark itself (``python -m pytest bench_port/tests``).

Tests marked ``card`` need a CUDA card and skip without one; the decision
is made inside the ``card`` fixture, never while a module is imported.
The rest run on the CPU at tiny sizes: ``tiny_root`` is a copy of the
benchmark's files whose configurations and cells are cut to a few users,
items and rows, so a whole run takes seconds.
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")


def shrink(root: str) -> None:
    """Cut every configuration and cell under ``root`` to a tiny size."""
    for f in os.listdir(os.path.join(root, "configs")):
        p = os.path.join(root, "configs", f)
        with open(p) as fh:
            c = json.load(fh)
        c["data"].update(n_users=60, n_items=50)
        if "n_ratings" in c["data"]:
            c["data"]["n_ratings"] = 400
        c["model"].update(embedding_dim=8, user_tower_dims=[16, 8], item_tower_dims=[16, 8],
                          dnn_dims=[16, 8])
        with open(p, "w") as fh:
            json.dump(c, fh)
    for f in os.listdir(os.path.join(root, "workloads")):
        p = os.path.join(root, "workloads", f)
        with open(p) as fh:
            w = json.load(fh)
        t = w["traffic"]
        if "batch" in t:
            t.update(batch=16, reference_rows=8)
            if t.get("negative_cache"):
                t["negative_cache"] = 16
            # a few hundred elements a leaf: one bf16 rounding that falls
            # the other way moves a leaf's norm by ~1e-3, where the cells'
            # millions average it out; the control reads 5e-3 / 9e-2 / 6e-2
            # here, a half batch 0.1 / 0.4 / 0.3
            w["limits"] = {"loss_gap": 1e-3, "grad_gap": 3e-2, "change_gap": 3e-2}
        else:
            t.update(rate=40.0, warm_batch=4, warm_requests=4, check_sample=16,
                     rerank_candidates=20)
        with open(p, "w") as fh:
            json.dump(w, fh)


def enlist_serve_cell(bench_path: str) -> None:
    """Add the serving cell, built and measured but not in
    ``BENCHMARK.json`` (PERF.md says why), with its metrics, as a later
    ``benchmark`` PR would (``serve_cell_entries.json``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "serve_cell_entries.json")) as f:
        extra = json.load(f)
    with open(bench_path) as f:
        bench = json.load(f)
    for key, entries in extra.items():
        bench[key] = bench[key] + entries
    with open(bench_path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    """-> the ``bench_port`` directory of a tiny copy (``BENCHMARK.json``
    beside it, with the serving cell enlisted)."""
    root = tmp_path / "bench_port"
    shutil.copytree(os.path.join(REPO, "bench_port"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    enlist_serve_cell(str(tmp_path / "BENCHMARK.json"))
    shrink(str(root))
    return str(root)


@pytest.fixture
def run_tiny(tiny_root):
    """-> run(cell, seed=..., trace=False, seconds=1.0): one CPU run of a
    tiny cell through the harness, past its look for a card."""
    import time

    from bench_port import harness

    def run(cell, seed=2**31 + 11, trace=False, seconds=1.0):
        c = harness.load_cell(cell, tiny_root)
        bench = harness.load_benchmark(os.path.dirname(tiny_root))
        return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), bench,
                                tiny_root)

    return run
