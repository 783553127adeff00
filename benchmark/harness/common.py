"""What every traffic kind shares: seeds, the set-up clock, the result of a
run, the per-layer readers' context and the card's description."""

from __future__ import annotations

import gc
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_T_IMPORT = time.perf_counter()


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any whole
    number, negative ones too)."""
    ss = np.random.SeedSequence(abs(int(seed)) * 2 + (int(seed) < 0))
    return [int(s) >> 1 for s in ss.generate_state(n, dtype=np.uint64)]


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start; from this module's import where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def phase(name: str) -> None:
    """Logs, on standard error, how far into its set-up the process is."""
    import sys

    print(f"setup {name}: {process_age_s():.2f} s", file=sys.stderr,
          flush=True)


@dataclass
class Run:
    """What a kind's ``run`` hands back to the harness."""

    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]          # by metric name (trace 0)
    checks: Dict[str, dict]
    memory_peak_bytes: int
    trace: Optional[object] = None        # TraceData (trace 1)
    work: Dict[str, object] = field(default_factory=dict)
    hosted: Optional[object] = None       # TraceData with the host's ops
    detail: Dict[str, object] = field(default_factory=dict)  # diagnostics


def drive(unit, seconds: float, device, trace: bool, hosted_units: int = 1,
          stats: Optional[dict] = None):
    """Runs ``unit()`` (one epoch, one slide: work that ends waiting for the
    card) until ``seconds`` have passed, at least once. Returns (units,
    window seconds, trace, hosted trace): with ``trace``, the units run
    under the device's trace, then ``hosted_units`` more under a trace of
    the host's operations too, for the idle gaps' labels. Without it,
    ``stats`` (when given) gets each unit's seconds (``unit_s``) and the
    seconds the interpreter's garbage collector held the window (``gc_s``),
    for the run's diagnostics."""
    from harness.trace import Traced

    if not trace:
        times, paused = [], [0.0, 0.0]

        def on_gc(what, _info):
            if what == "start":
                paused[1] = time.perf_counter()
            else:
                paused[0] += time.perf_counter() - paused[1]

        gc.callbacks.append(on_gc)
        try:
            n, t0 = 0, time.perf_counter()
            while True:
                t1 = time.perf_counter()
                unit()
                n += 1
                t2 = time.perf_counter()
                times.append(t2 - t1)
                if t2 - t0 >= seconds:
                    break
        finally:
            gc.callbacks.remove(on_gc)
        if stats is not None:
            stats.update(unit_s=times, gc_s=paused[0])
        return n, t2 - t0, None, None
    with Traced(device) as traced:
        n, t0 = 0, time.perf_counter()
        while True:
            unit()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
    with Traced(device, host=True) as hosted:
        for _ in range(hosted_units):
            unit()
    return n, traced.data.window_s, traced.data, hosted.data


def unit_summary(stats: dict) -> dict:
    """The window's units in a few numbers: count, quartiles and extremes
    of their seconds, and the garbage collector's share of the window."""
    times = stats.get("unit_s") or []
    if not times:
        return {}
    q = (statistics.quantiles(times, n=4) if len(times) > 1
         else [times[0]] * 3)
    return {"units": len(times), "unit_min_s": min(times),
            "unit_q1_s": q[0], "unit_median_s": q[1], "unit_q3_s": q[2],
            "unit_max_s": max(times),
            "gc_share": stats.get("gc_s", 0.0) / max(sum(times), 1e-30)}


@dataclass
class Context:
    """What a per-layer reader reads: the traced stretch, the cell, the
    work counted over the stretch (by the kind, from shapes) and the
    program's counters."""

    trace: object
    cell: object
    work: Dict[str, object]
    device_kind: str

    def peaks(self) -> dict:
        from harness.spec import peaks

        row = peaks(self.device_kind)
        if row is None:
            raise ValueError(f"no published peaks for {self.device_kind!r} "
                             f"in benchmark/peaks.json")
        return row

    def family_seconds(self, family: str, kinds=("kernel",)) -> float:
        """Device seconds of the traced operations of a kernel family
        (``benchmark/kernels/<family>.json``)."""
        from harness.spec import in_family, kernel_table

        table = kernel_table(family)
        return self.trace.seconds_of(
            lambda op: op.kind in kinds and in_family(table, op.name))


def share_pct(bound_s: float, seconds: float) -> Optional[float]:
    """A share of a bound in %; None when nothing was measured."""
    if seconds <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / seconds
