"""The trace arithmetic: the union of device intervals (not the sum of
durations), idle gaps named by what the host was doing, and the readers
built on them."""

from types import SimpleNamespace

import pytest

from bench_port import readers, tracing
from bench_port.work.peaks import bound_s


@pytest.mark.parametrize("intervals,union", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(0, 2), (1, 3)], 3.0),          # overlap counted once
    ([(0, 4), (1, 2)], 4.0),          # nested (a copy under a kernel)
    ([(5, 6), (0, 1), (2, 3)], 3.0),  # out of order, disjoint
    ([(0, 1), (1, 2)], 2.0),          # touching
])
def test_union(intervals, union):
    assert tracing.union_seconds(intervals) == union


def test_union_never_exceeds_the_span_of_its_events():
    # two streams busy at once: the sum of durations is 2x the union
    ivs = [(i, i + 1.0) for i in range(10)] + [(i + 0.5, i + 1.5) for i in range(10)]
    assert sum(e - s for s, e in ivs) == 20.0
    assert tracing.union_seconds(ivs) == 10.5


def test_idle_gaps_are_named_by_the_host_span():
    call_a = SimpleNamespace(name="bench.service")
    call_b = SimpleNamespace(name="bench.service")
    events = [(0, 1, "op.topk", call_a), (3, 4, "service", call_a),   # 2 s inside a call
              (10, 11, "op.topk", call_b)]                            # 6 s between calls
    assert tracing.idle_gaps(events) == [("before service", 6), ("service", 2)]


def test_parse_op():
    assert tracing.parse_op("bench.op.topk|q=8|n=3883|d=128|k=200") == (
        "topk", {"q": 8, "n": 3883, "d": 128, "k": 200})
    assert tracing.parse_op("bench.op.flash_ce_bwd|bq=4|dtype=bf16")[1] == {
        "bq": 4, "dtype": "bf16"}


def test_readers():
    tr = tracing.Trace()
    tr.window_s, tr.busy_s, tr.n_device_events = 10.0, 2.0, 5
    assert readers.idle_share({"trace": tr}) == pytest.approx(80.0)
    # one top-k call whose device time is 10x its bound
    t, _ = bound_s(2.0 * 8 * 3883 * 128, 4.0 * (8 * 128 + 3883 * 128) + 8 * 200 * 12, "fp32")
    tr.op_calls["topk"].append(({"q": 8, "n": 3883, "d": 128, "k": 200}, 10 * t))
    share, note = readers.roofline({"trace": tr}, "topk")
    assert share == pytest.approx(10.0) and "bytes" in note
    assert readers.roofline({"trace": tr}, "flash_ce_fwd") is None
    assert readers.idle_share({"trace": None}) is None
