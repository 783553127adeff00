"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over the
card and the host, read from the tracer's own records (the card's kernel,
copy and set records; each kernel of a CUDA graph's replays is a record of
its own), not through ``prof.events()``, which cannot take a stretch of
10^5 records in reasonable time. Nothing is written to disk."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

WINDOW = "bench.window"


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int

    @property
    def kind(self) -> str:
        if self.name.startswith("Memcpy"):
            return "memcpy"
        if self.name.startswith("Memset"):
            return "memset"
        return "kernel"

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class TraceData:
    """The device's records of the stretch, the host's records (a stretch
    traced with them), the window and the merged intervals in which some
    operation ran on the card. ``window_s`` is the host's clock between two
    waits for the card around the stretch; ``window`` the harness's
    ``bench.window`` span in the tracer's clock where the host was traced."""

    ops: List[DeviceOp]
    host: List[Tuple[str, int, int, bool]]       # name, start, end, span
    window: Tuple[int, int]
    busy: List[Tuple[int, int]]
    window_s: float

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def seconds_of(self, pred) -> float:
        return sum(op.seconds for op in self.ops if pred(op))


def _merge(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Traced:
    """``with Traced(device, host) as t: ...`` profiles the block; afterwards
    ``t.data`` is its :class:`TraceData`. The block's work is waited for
    inside the window. With ``host`` the host's operations are traced too,
    which slows the host's dispatch: the per-layer metrics read a stretch
    traced without them, the idle gaps' labels a second stretch with them."""

    def __init__(self, device, host: bool = False):
        self.device, self.host = device, host
        self.data: TraceData = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        ops, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name, s, d = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # the harness's and the schedule's spans are mirrored on
                # the device's timeline: not operations
                if not (e.is_user_annotation() or name == WINDOW
                        or name.startswith("ProfilerStep")):
                    ops.append(DeviceOp(name, s, s + d))
            elif name == WINDOW and window is None:
                window = (s, s + d)
            else:
                host.append((name, s, s + d, bool(e.is_user_annotation())))
        if window is not None:
            lo, hi = window
            ops = [op for op in ops if op.end_ns > lo and op.start_ns < hi]
        elif self.host:
            raise RuntimeError("the profiler lost the window's span")
        else:
            # the host is not traced: the stretch's own operations, between
            # the waits for the card
            lo = min((op.start_ns for op in ops), default=0)
            hi = max((op.end_ns for op in ops), default=0)
            window = (lo, hi)
        busy = _merge((max(op.start_ns, lo), min(op.end_ns, hi))
                      for op in ops)
        self.data = TraceData(ops, host, window, busy, window_s)
        self._prof = None
        return False


def _host_label(host, at: int) -> str:
    """What the host was doing at ``at``: the innermost span of the
    harness's and the innermost other record that cover it."""
    span = op = None
    for name, s, e, is_span in host:
        if s <= at < e:
            if is_span:
                if span is None or e - s < span[1]:
                    span = (name, e - s)
            elif op is None or e - s < op[1]:
                op = (name, e - s)
    parts = [p[0] for p in (span, op) if p is not None]
    return " / ".join(parts) if parts else "no host record"


def breakdown(data: TraceData, hosted: TraceData, top: int = 10) -> dict:
    """The device operations that took most time in ``data`` (summed by
    name), and the longest idle gaps of ``hosted`` (a stretch traced with
    the host's operations), each named by what the host was doing in its
    middle."""
    by_name = defaultdict(float)
    for op in data.ops:
        by_name[op.name] += op.seconds
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    data = hosted
    lo, hi = data.window
    edges = [lo] + [x for iv in data.busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(data.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = []
    for s, e in gaps:
        mid = (s + e) // 2
        # records that start before the middle; a long one may start early
        cut = bisect.bisect_right(starts, mid)
        idle.append([_host_label(host[:cut], mid), (e - s) / 1e9])
    return {"device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": idle}
