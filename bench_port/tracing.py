"""The traced run: the benchmark's own spans around calls into the
program's layers, the profiler, and the reduction of its trace to device
intervals, per-span device time, busy share and breakdown.

A span is a profiler range named ``bench.<layer>`` (a layer's call) or
``bench.op.<operation>|key=value|...`` (an operation, with the shape its
work is counted from). It is a function-scope range, not a user
annotation: the profiler links a kernel to the innermost function-scope
range open when it was launched (a user annotation is tracked apart), so a
kernel launched through ctypes inside a span links to the span itself.
Spans are installed only in the traced run, by wrapping the program's
functions where they are looked up.

A device event (kernel, copy, set) belongs to the host op it is linked to
by correlation id (the innermost range open on the launching thread), and
through that op to every span open around it on that thread. It counts
in the window when that op started inside the ``bench.window`` range, so
the skew between the host's and the device's clocks keeps or drops no
record at the ends. Busy time is the union of the counted intervals, not
the sum of their durations.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"
PREFIX = "bench."
OP_PREFIX = "bench.op."


def span_name(name: str, **shape) -> str:
    return name + "".join(f"|{k}={v}" for k, v in shape.items())


def parse_op(name: str) -> Tuple[str, Dict[str, object]]:
    """``bench.op.topk|q=8|n=3883`` -> ("topk", {"q": 8, "n": 3883})."""
    head, *parts = name.split("|")
    shape = {}
    for p in parts:
        k, v = p.split("=", 1)
        shape[k] = int(v) if v.lstrip("-").isdigit() else v
    return head[len(OP_PREFIX):], shape


class Patches:
    """Wrappers installed on attributes of modules, classes or objects and
    taken out again on exit, so that a traced run leaves nothing behind."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, make: Callable[[Callable], Callable]) -> bool:
        """Replace ``owner.attr`` by ``make(original)``; False (and nothing
        done) where the program has no such attribute."""
        if not hasattr(owner, attr):
            return False
        orig = owner.__dict__.get(attr, getattr(owner, attr)) if isinstance(owner, type) \
            else getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig
        new = make(fn)
        setattr(owner, attr, staticmethod(new) if isinstance(orig, staticmethod) else new)
        return True

    def undo(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def span(name: str):
    """A function-scope profiler range ``name`` (a context manager)."""
    import torch

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    from torch.profiler import record_function

    return record_function(name)


def spanned(name: str, shape_of: Optional[Callable] = None) -> Callable[[Callable], Callable]:
    """-> a wrapper factory: each call runs inside a span ``name`` (with
    the shape ``shape_of(*args, **kwargs)`` gives, where given)."""

    def make(fn):
        def wrapped(*args, **kwargs):
            label = span_name(name, **shape_of(*args, **kwargs)) if shape_of else name
            with span(label):
                return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    return make


@contextlib.contextmanager
def profiler(enabled: bool):
    """The profiler (host ops and device activity) while ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    import torch

    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


class _Op:
    __slots__ = ("name", "thread", "start", "end", "corr")

    def __init__(self, name, thread, start, end, corr):
        self.name, self.thread, self.start, self.end, self.corr = name, thread, start, end, corr


class Trace:
    """The reduced trace of one traced window."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.n_device_events = 0
        # per span name (without shape): device seconds of events under it
        self.span_device_s: Dict[str, float] = defaultdict(float)
        # per operation: [(shape, device seconds)] of each call
        self.op_calls: Dict[str, List[Tuple[Dict, float]]] = defaultdict(list)
        # host seconds of each call of each span name (inside the window)
        self.span_host_s: Dict[str, List[float]] = defaultdict(list)
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []

    def breakdown(self) -> Dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def _enclosing(index, t) -> List[_Op]:
    """Spans open at host time ``t``, innermost first. Spans nest in time
    across threads too: the caller of a backward waits while the autograd
    thread runs it."""
    if index is None:
        return []
    starts, spans, parent = index
    i = bisect.bisect_right(starts, t) - 1
    out = []
    while i >= 0:
        s = spans[i]
        if s.end >= t:
            out.append(s)
        i = parent[i]
    return out


def _index_spans(spans: List[_Op]):
    if not spans:
        return None
    lst = sorted(spans, key=lambda s: (s.start, -s.end))
    parent, stack = [], []
    for i, s in enumerate(lst):
        while stack and lst[stack[-1]].end < s.start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return [s.start for s in lst], lst, parent


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end] intervals (any units in, same out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(events: List[Tuple[float, float, str, object]]) -> List[Tuple[str, float]]:
    """Device idle gaps between ``(start, end, label, call)`` events, summed
    by what the host was doing: a gap inside one outermost span call is the
    host's work in the innermost span of the event that ends it (``label``);
    a gap between two calls is named ``before <label of the next call>``.
    Longest total first."""
    sums: Dict[str, float] = defaultdict(float)
    reach, prev_call = None, None
    for s, e, label, call in sorted(events, key=lambda ev: ev[0]):
        if reach is not None and s > reach:
            if call is not None and call is prev_call:
                sums[label] += s - reach
            else:
                outer = call.name.split("|")[0][len(PREFIX):] if call is not None else "other"
                sums["before " + outer] += s - reach
        reach = e if reach is None else max(reach, e)
        prev_call = call
    return sorted(sums.items(), key=lambda kv: -kv[1])


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu") and name[2:3].isupper()


def reduce(prof) -> Trace:
    """The window's numbers from a finished profiler session."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops: Dict[int, _Op] = {}
    spans: List[_Op] = []
    window = None
    device = []
    for e in events:
        dt = e.device_type()
        if dt == DeviceType.CPU:
            name = e.name()
            if _is_runtime(name):
                continue
            start = e.start_ns()
            op = _Op(name, e.start_thread_id(), start, start + e.duration_ns(),
                     e.correlation_id())
            ops[op.corr] = op
            if name.startswith(PREFIX):
                if name == WINDOW:
                    window = window or op
                else:
                    spans.append(op)
        elif not e.is_user_annotation():
            device.append(e)
    tr = Trace()
    if window is None:
        return tr
    lo, hi = window.start, window.end
    tr.window_s = (hi - lo) / 1e9
    index = _index_spans(spans)
    intervals, labelled = [], []
    by_kernel: Dict[str, float] = defaultdict(float)
    call_s: Dict[int, float] = defaultdict(float)
    span_of: Dict[int, _Op] = {}
    for e in device:
        op = ops.get(e.linked_correlation_id())
        if op is None or not (lo <= op.start <= hi):
            continue
        s, dur = e.start_ns(), e.duration_ns()
        intervals.append((s, s + dur))
        by_kernel[e.name()] += dur / 1e9
        open_spans = _enclosing(index, op.start)
        label = open_spans[0].name.split("|")[0][len(PREFIX):] if open_spans else "other"
        labelled.append((s, s + dur, label, open_spans[-1] if open_spans else None))
        seen = set()
        for sp in open_spans:
            base = sp.name.split("|")[0]
            if base not in seen:
                seen.add(base)
                tr.span_device_s[base[len(PREFIX):]] += dur / 1e9
            if sp.name.startswith(OP_PREFIX):
                call_s[id(sp)] += dur / 1e9
                span_of[id(sp)] = sp
    tr.n_device_events = len(intervals)
    tr.busy_s = union_seconds(intervals) / 1e9
    for key, secs in call_s.items():
        name, shape = parse_op(span_of[key].name)
        tr.op_calls[name].append((shape, secs))
    for sp in spans:
        if lo <= sp.start <= hi:
            tr.span_host_s[sp.name.split("|")[0][len(PREFIX):]].append((sp.end - sp.start) / 1e9)
    tr.device_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    tr.idle_gaps = [(k, v / 1e9) for k, v in idle_gaps(labelled)]
    return tr
