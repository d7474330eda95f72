"""The import guard: nothing under ``bench_port/`` imports JAX or the JAX
package, and the plain reference imports nothing of the program. Names
are compared whole, as the part before the first dot: the port's name
begins with the JAX package's."""

import ast
import os
import sys

import pytest

from bench_port import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "recsys_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(ROOT, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(n for n in _imports(p) if n == "recsys_tpu_torch" or n in FORBIDDEN)
           for p in _sources("reference")}
    assert not {p: b for p, b in bad.items() if b}
    # and it computes with plain torch and numpy only, besides its own package
    allowed = {"torch", "numpy", "math", "typing", "__future__", "bench_port"}
    extra = {p: sorted(set(_imports(p)) - allowed) for p in _sources("reference")}
    assert not {p: e for p, e in extra.items() if e}


@pytest.mark.parametrize("name,flagged", [
    ("recsys_tpu", True), ("recsys_tpu.ops", True), ("jax.numpy", True), ("jaxlib", True),
    ("flax.linen", True), ("recsys_tpu_torch", False), ("recsys_tpu_torch.ops", False),
    ("jaxtyping", False)])
def test_run_time_guard_compares_whole_top_level_names(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, f"{name}", object())
    assert (name in harness.forbidden_modules()) is flagged
