"""The roofline share of an operation whose counts ``work/dlrm.py`` gives
(the shared ``readers.roofline`` reads ``work/ops.py``'s)."""

from __future__ import annotations

from typing import Callable, Optional

from bench_port.work.peaks import bound_s


def roofline(res, op: str, counts: Callable, **extra) -> Optional[tuple]:
    """Share (%) of the least time the calls of ``op`` in the traced window
    need at the published peaks (``counts(**shape, **extra)``), over the
    device time of the work launched under them -> (share, which bound) or
    None where the run has no such call."""
    tr = res.get("trace")
    calls = tr.op_calls.get(op) if tr is not None else None
    if not calls:
        return None
    least, kinds = 0.0, set()
    for shape, _ in calls:
        t, kind = bound_s(*counts(**shape, **extra))
        least += t
        kinds.add(kind)
    device = sum(s for _, s in calls)
    if device <= 0:
        return None
    return 100.0 * least / device, f"bound by {'/'.join(sorted(kinds))} over {len(calls)} calls"


def unique_rows(res) -> Optional[float]:
    """The rows a step updated (the program's counter, read after the
    window), or None where the program has no such counter."""
    return res.get("stats", {}).get("unique_rows_per_step")
