"""Helpers the per-layer metric readers share. A reader returns None
where its run has nothing to read, and the harness leaves the metric out."""

from __future__ import annotations

from typing import Optional

from bench_port.work.ops import op_work
from bench_port.work.peaks import BF16_FLOPS, bound_s


def roofline(res, op: str):
    """Share (%) of the least time the calls of ``op`` in the traced
    window need at the published peaks, over the device time of all the
    work launched under them -> (share, which bound) or None."""
    tr = res.get("trace")
    calls = tr.op_calls.get(op) if tr is not None else None
    if not calls:
        return None
    least, kinds = 0.0, set()
    for shape, _ in calls:
        t, kind = bound_s(*op_work(op, shape))
        least += t
        kinds.add(kind)
    device = sum(s for _, s in calls)
    if device <= 0:
        return None
    return 100.0 * least / device, f"bound by {'/'.join(sorted(kinds))} over {len(calls)} calls"


def idle_share(res) -> Optional[float]:
    tr = res.get("trace")
    if tr is None or tr.window_s <= 0 or tr.n_device_events == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / BF16_FLOPS


def peak_gib(res) -> Optional[float]:
    peak = res.get("memory_peak_bytes", 0)
    return peak / 2**30 if peak else None
