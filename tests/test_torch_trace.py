"""The port's spans (``utils/trace.py``) through the trainer's step, on the
CPU: under ``torch.profiler`` each step holds ``train.step`` around
``train.forward`` (around ``loss.retrieval``), ``train.backward`` (around
``loss.retrieval_bwd`` on the flash route) and ``train.update``, and
``train.cache_update`` with the CBNS cache; every one is a function-scope
range, and the profiler changes no bit of the step. The mesh's
``train.exchange`` is checked in ``tests/test_torch_dp_train.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer
from recsys_tpu_torch.utils import trace

B, N_USERS, N_ITEMS, STEPS = 64, 30, 40, 2
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(16,), item_tower_dims=(16,),
                cross_layers=2, dnn_dims=(16,), dropout_rate=0.2, use_flash_ce=True)
# span -> the span it nests in (None: the step itself)
NESTING = {"train.step": None, "train.forward": "train.step",
           "loss.retrieval": "train.forward", "train.backward": "train.step",
           "loss.retrieval_bwd": "train.backward", "train.update": "train.step",
           "train.cache_update": "train.step"}


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"user_id": torch.from_numpy(rng.integers(0, N_USERS, B).astype(np.int32)),
             "movie_id": torch.from_numpy(rng.integers(0, N_ITEMS, B).astype(np.int32)),
             "rating": torch.from_numpy(rng.uniform(1, 5, B).astype(np.float32)),
             "y_implicit": torch.from_numpy((rng.random(B) > 0.5).astype(np.float32))}
            for _ in range(STEPS)]


def _steps(tmp_path, sparse, cache, profiled):
    """-> (state, stacked metrics, the profiler or None) after STEPS steps
    from one init."""
    cfg = RecsysConfig(model=ModelConfig(**MODEL_KW),
                       train=TrainConfig(batch_size=B, sparse_table_updates=sparse,
                                         negative_cache=cache))
    tr = Trainer(cfg, str(tmp_path / f"run{int(profiled)}"), device="cpu")
    state = tr.init_state(N_USERS, N_ITEMS, 0)
    step = tr.make_train_step((1.2, 0.8))
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    metrics = []
    if prof is not None:
        prof.start()
    try:
        for b in _batches():
            state, m = step(state, b)
            metrics.append(torch.stack([m[k] for k in sorted(m)]))
    finally:
        if prof is not None:
            prof.stop()
    assert tr.step_counts["sparse" if sparse else "dense"] == STEPS
    return state, torch.stack(metrics), prof


@pytest.mark.parametrize("cache", [0, 2 * B], ids=["nocache", "cache"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_step_spans_nest_once_a_step_and_change_no_bit(sparse, cache, tmp_path):
    plain, plain_metrics, _ = _steps(tmp_path, sparse, cache, profiled=False)
    traced, traced_metrics, prof = _steps(tmp_path, sparse, cache, profiled=True)

    spans = {}
    for e in prof.events():
        if e.name.startswith(("train.", "loss.")):
            assert e.scope != torch._C._profiler.RecordScope.USER_SCOPE.value, e.name
            spans.setdefault(e.name, []).append(e.time_range)
    want = {n for n in NESTING if cache or n != "train.cache_update"}
    assert set(spans) == want
    for name, ranges in spans.items():
        assert len(ranges) == STEPS, name
        ranges.sort(key=lambda r: r.start)
    for name, parent in NESTING.items():
        if name not in spans or parent is None:
            continue
        for inner, outer in zip(spans[name], spans[parent]):
            assert outer.start <= inner.start and inner.end <= outer.end, (name, parent)
    for i in range(STEPS):  # the phases in order inside each step
        order = [spans[n][i] for n in ("train.forward", "train.backward", "train.update")]
        assert all(a.end <= b.start for a, b in zip(order, order[1:]))

    assert torch.equal(plain_metrics, traced_metrics)
    for tree in ("params", "opt_state", "extras"):
        got = dict(leaves_with_paths(getattr(traced, tree) or {}))
        for path, want_leaf in leaves_with_paths(getattr(plain, tree) or {}):
            assert torch.equal(got[path], want_leaf), (tree, path)


def test_span_is_function_scope_and_its_fallback_a_user_annotation(monkeypatch):
    """Without ``_RecordFunctionFast`` a span is ``record_function``'s
    user-scope range (to which no ctypes kernel links); without a profiler
    either records nothing and the block runs."""
    with trace.span("loss.retrieval"):
        x = torch.ones(3) + 1
    scopes = {}
    for fallback in (False, True):
        if fallback:
            monkeypatch.setattr(trace, "_FAST", None)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("loss.retrieval"):
                x = x + 1
        scopes[fallback] = [e.scope for e in prof.events() if e.name == "loss.retrieval"]
    user = torch._C._profiler.RecordScope.USER_SCOPE.value
    assert scopes == {False: [torch._C._profiler.RecordScope.FUNCTION.value], True: [user]}
    assert torch.equal(x, torch.full((3,), 4.0))
