"""Profiling hooks and the port's one span and counter registry; the port
of ``acmil_tpu/utils/profiling.py``.

``profile_trace`` wraps a block in a ``torch.profiler`` trace (a Chrome
trace under ``log_dir``, and the profile itself for the caller to read;
``device_events`` reads the card's work from it);
``StepTimer`` times steps between ticks: on a CUDA device with CUDA events
on the current stream, each tick waiting for the work before it, on the
CPU with the host clock.

**Spans and counters.** The program names its layers with
``with span(name):`` and counts work with ``count(name, n)``. Off, the
default, ``span`` hands back one shared no-op context (a
``record_function`` range while a ``torch.profiler`` is active, so that the
profiler's timeline names the program's layers) and ``count`` returns at
once. On (``spans_on(True)``, or ``ACMIL_TORCH_SPANS=<path>`` in the
environment when this module is imported), each span is a record kept in
memory: its name, its start and end on the host's ``perf_counter_ns``
clock and the span that encloses it. A span made with ``device=True`` also
records a timing CUDA event pair on the current stream, from a reused
pool, whose device interval is put on the host's clock through an anchor
event recorded while the card's queue was empty: at ``reset()`` (after a
synchronise) and again at each ``settle()``, which the program calls right
after it has waited for the card. Finished pairs are read while the host
runs ahead of the card (once more than ``_SETTLE_AT`` wait), not where the
card waits on the host, and the rest at ``snapshot()``: tracing adds no
synchronisation of its own. Inside a CUDA-graph capture a device span
records host time only.

``reset()`` starts a stretch, ``snapshot()`` sums it: per span name its
count, host seconds, self seconds (less the time its child spans cover)
and, for device spans, device seconds; the counters; and the raw records.
Objects that keep their own totals (``engine/graphs.py::GraphSteps``) give
them to the registry with ``counter_source``, and the snapshot holds what
they grew by over the stretch, after the objects are gone too. With ``ACMIL_TORCH_SPANS`` set, the stretch
is written to that path when the interpreter exits, as one Chrome trace
(``chrome://tracing``, Perfetto): host rows and device rows on the host's
clock; ``benchmark/tools/spans.py`` summarises such a file.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

ENV = "ACMIL_TORCH_SPANS"
# device pairs left waiting before a span's end looks for finished ones
_SETTLE_AT = 256


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device=None, cpu: bool = True):
    """A ``torch.profiler`` context over the block whose Chrome trace is
    written under ``log_dir`` when the block ends; yields the profile. It
    traces the CPU and, when ``device`` is a CUDA device, the card (then
    the card alone with ``cpu=False``). A falsy ``log_dir`` traces nothing
    and yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    card = device is not None and torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] if cpu or not card else []
    if card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=torch.profiler
                 .tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def device_events(prof):
    """(name, ms) of each kernel, copy and set a finished profile saw on the
    card, read from the tracer's own records (faster than
    ``prof.events()`` over tens of thousands of launches). A schedule's
    step annotation, which spans the step on the device too, is left out;
    each kernel of a CUDA graph's replays is an event of its own."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith("ProfilerStep")]


class StepTimer:
    """Step timing that sees the device's work: ``tick()`` returns the
    seconds since the last tick (or since the timer was made). On a CUDA
    ``device`` that is the time between two CUDA events on the current
    stream, the second waited on; on the CPU, the host clock's."""

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self.steps = 0
        self._cuda = self.device.type == "cuda"
        self.t0 = time.perf_counter()
        self._e0 = self._record() if self._cuda else None

    def _record(self) -> "torch.cuda.Event":
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def tick(self) -> float:
        now = time.perf_counter()
        if self._cuda:
            e1 = self._record()
            e1.synchronize()
            dt = self._e0.elapsed_time(e1) / 1e3
            self._e0, now = e1, time.perf_counter()
        else:
            dt = now - self.t0
        self.t0 = now
        self.steps += 1
        return dt


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

class Record(NamedTuple):
    """One span of a stretch. Times are ``perf_counter_ns``; ``parent`` is
    the index of the enclosing span in the stretch's records (-1 at the
    top); the device interval, on the same clock, is None for a host span
    (or a device span inside a capture)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int
    device_start_ns: Optional[int]
    device_end_ns: Optional[int]


class _Anchor:
    """An event recorded while the card's queue was empty, and the host's
    clock just before it was recorded."""

    def __init__(self):
        self.host_ns = time.perf_counter_ns()
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record()
        self.device = torch.cuda.current_device()

    def at(self, event) -> int:
        return self.host_ns + round(self.event.elapsed_time(event) * 1e6)


class _Span:
    __slots__ = ("reg", "name", "device", "rec", "stack", "range", "pair")

    def __init__(self, reg: "Registry", name: str, device: bool):
        self.reg, self.name, self.device = reg, name, device

    def __enter__(self):
        reg = self.reg
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.stack = reg._stack()
        self.rec = reg._open(self.name, self.stack)
        self.pair = reg._device_begin() if self.device else None
        self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.pair is not None:
            self.reg._device_end(self.rec, self.pair)
        self.rec[2] = end
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Registry:
    """The process's spans and counters; the module's functions act on one
    instance of it."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._free: List[torch.cuda.Event] = []
        self._pending = collections.deque()
        self._sources: Dict[Callable[[], Dict[str, float]], dict] = {}
        self.reset()

    # -- a stretch ----------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._records: List[list] = []
            self._counts: Dict[str, float] = {}
            self._local = threading.local()
            # pairs of the last stretch are dropped: their events may be
            # recorded anew, whether they have finished or not
            for _, e0, e1, _ in self._pending:
                self._free += (e0, e1)
            self._pending.clear()
            self._anchor: Optional[_Anchor] = None
            for src in self._sources:
                self._sources[src] = src()
            self._t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self._anchor = _Anchor()

    def snapshot(self) -> dict:
        """The stretch so far: ``spans`` (per name: ``count``, ``host_s``,
        ``self_s`` and, where its spans were device-timed, ``device_s``),
        ``counters``, ``records`` (:class:`Record` in start order) and
        ``window_ns`` (the stretch's start and now). Waits for the device
        pairs still pending."""
        self._settle(wait=True)
        with self._lock:
            recs = [Record(*r) for r in self._records]
            counters = dict(self._counts)
            sources = list(self._sources.items())
        for src, base in sources:
            for k, v in src().items():
                grown = v - base.get(k, 0)
                if grown:
                    counters[k] = counters.get(k, 0) + grown
        return {"spans": summary(recs), "counters": counters,
                "records": recs,
                "window_ns": (self._t0, time.perf_counter_ns())}

    # -- spans --------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, stack: list) -> list:
        rec = [name, 0, 0, stack[-1] if stack else -1, threading.get_ident(),
               None, None]
        with self._lock:
            stack.append(len(self._records))
            self._records.append(rec)
        return rec

    def _device_begin(self):
        if (not torch.cuda.is_initialized()
                or torch.cuda.is_current_stream_capturing()):
            return None
        if self._anchor is None:
            torch.cuda.synchronize()
            self._anchor = _Anchor()
        if torch.cuda.current_device() != self._anchor.device:
            return None
        e0 = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        e0.record()
        return e0, self._anchor

    def _device_end(self, rec: list, pair) -> None:
        e0, anchor = pair
        e1 = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        e1.record()
        self._pending.append((rec, e0, e1, anchor))
        if len(self._pending) > _SETTLE_AT:
            self._settle(wait=False)

    def _settle(self, wait: bool) -> None:
        """Puts the pending pairs that have finished (all, with ``wait``)
        on the host's clock and returns their events to the pool."""
        pending = self._pending
        while pending:
            rec, e0, e1, anchor = pending[0]
            if wait:
                e1.synchronize()
            elif not e1.query():
                break
            rec[5], rec[6] = anchor.at(e0), anchor.at(e1)
            self._free += (e0, e1)
            pending.popleft()

    def settle(self) -> None:
        if self.on and self._anchor is not None:
            # the caller has just waited for the card: its queue is empty
            self._anchor = _Anchor()

    def add(self, name: str, n) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def add_source(self, totals: Callable[[], Dict[str, float]]) -> None:
        with self._lock:
            self._sources[totals] = {}

    # -- the Chrome trace ---------------------------------------------------
    def export(self, path: str) -> None:
        """The stretch as one Chrome trace at ``path``: the host's spans on
        process 1 (a row a thread), the device intervals on process 2, both
        in microseconds from the stretch's start; each event's ``args``
        hold its record's index and its parent's. The counters are under
        ``otherData``."""
        snap = self.snapshot()
        t0 = snap["window_ns"][0]
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": name}}
                  for pid, name in ((1, "host"), (2, "device"))]
        for i, r in enumerate(snap["records"]):
            args = {"index": i, "parent": r.parent}
            events.append({"name": r.name, "ph": "X", "pid": 1,
                           "tid": r.thread, "ts": (r.start_ns - t0) / 1e3,
                           "dur": (r.end_ns - r.start_ns) / 1e3,
                           "args": args})
            if r.device_start_ns is not None:
                events.append({
                    "name": r.name, "ph": "X", "pid": 2, "tid": 0,
                    "ts": (r.device_start_ns - t0) / 1e3,
                    "dur": (r.device_end_ns - r.device_start_ns) / 1e3,
                    "args": args})
        other = {"counters": snap["counters"], "t0_ns": t0,
                 "window_us": (snap["window_ns"][1] - t0) / 1e3}
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": other}, f)


def summary(records: List[Record]) -> Dict[str, dict]:
    """Per span name: ``count``, ``host_s``, ``self_s`` (less what its
    child spans cover) and, where its spans were device-timed,
    ``device_s``."""
    child = [0] * len(records)
    for r in records:
        if r.parent >= 0:
            child[r.parent] += r.end_ns - r.start_ns
    spans: Dict[str, dict] = {}
    for r, c in zip(records, child):
        s = spans.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0})
        s["count"] += 1
        s["host_s"] += (r.end_ns - r.start_ns) / 1e9
        s["self_s"] += (r.end_ns - r.start_ns - c) / 1e9
        if r.device_start_ns is not None:
            s["device_s"] = s.get("device_s", 0.0) + (
                r.device_end_ns - r.device_start_ns) / 1e9
    return spans


_NOOP = contextlib.nullcontext()
_REGISTRY = Registry()


def span(name: str, device: bool = False):
    """A context naming a layer of the program: a record of the stretch when
    spans are on (device-timed too with ``device``), a ``record_function``
    range while a ``torch.profiler`` is active, else one shared no-op."""
    if _REGISTRY.on:
        return _Span(_REGISTRY, name, device)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NOOP


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name`` when spans are on."""
    if _REGISTRY.on:
        _REGISTRY.add(name, n)


def settle() -> None:
    """Called right after the host has waited for the card (a read-back):
    the card's empty queue anchors the next device pairs. Nothing when
    spans are off."""
    _REGISTRY.settle()


def spans_on(on: bool) -> None:
    _REGISTRY.on = bool(on)


def reset() -> None:
    """Starts a stretch: no records, no counts."""
    _REGISTRY.reset()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def counter_source(totals: Callable[[], Dict[str, float]]) -> None:
    """Registers ``totals()``, which returns totals kept elsewhere by name:
    a snapshot holds what they grew by over the stretch. The registry keeps
    it for the process's life, so it should hold no more than the totals
    (a bound method would keep its object alive)."""
    _REGISTRY.add_source(totals)


if os.environ.get(ENV):
    spans_on(True)
    atexit.register(_REGISTRY.export, os.path.abspath(os.environ[ENV]))
