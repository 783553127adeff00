"""Profiling hooks, the port of ``acmil_tpu/utils/profiling.py``.

``profile_trace`` wraps a block in a ``torch.profiler`` trace (a Chrome
trace under ``log_dir``, and the profile itself for the caller to read;
``device_events`` reads the card's work from it);
``StepTimer`` times steps between ticks: on a CUDA device with CUDA events
on the current stream, each tick waiting for the work before it, on the
CPU with the host clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


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

    def device_memory_mb(self) -> Optional[float]:
        """Memory the caching allocator holds for tensors on the CUDA
        device, in MB; None on the CPU."""
        if not self._cuda:
            return None
        return torch.cuda.memory_allocated(self.device) / 1e6
