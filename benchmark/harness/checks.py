"""The comparisons that decide ``correct``: each number is a gap between
what the program produced and what the plain reference produced from the
same inputs, and each has its limit in ``benchmark/limits/<cell>.json``
(``PERF.md`` gives the readings each limit was set from)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; infinite when ``got`` is not finite."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def norm(t) -> float:
    return float(np.linalg.norm(np.asarray(t, dtype=np.float64).ravel()))


def leaf_gaps(got: Dict[str, object], want: Dict[str, object],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    ``| |got| - |want| | / max(|want|, median leaf |want|)``: the norms, not
    the norm of the difference, against the larger of the leaf's own norm
    and the median leaf's, since some leaves are all but zero. ``leaves``
    limits the comparison (and the median) to those names."""
    names = list(want) if leaves is None else list(leaves)
    ref = {k: norm(want[k]) for k in names}
    med = statistics.median(ref.values())
    out = {}
    for k in names:
        g = norm(got[k])
        out[k] = (abs(g - ref[k]) / max(ref[k], med, 1e-30)
                  if math.isfinite(g) else math.inf)
    return out


def leaf_gap(got: Dict[str, object], want: Dict[str, object],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap of :func:`leaf_gaps`: (gap, leaf)."""
    gaps = leaf_gaps(got, want, leaves)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moving_leaves(grad_ref: Dict[str, object], share: float = 1e-3):
    """The leaves whose reference gradient is more than ``share`` of the
    median leaf's: the others (a key's bias under softmax) move under Adam
    by round-off alone and are left out of the change."""
    norms = {k: norm(v) for k, v in grad_ref.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n > share * med]


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): ``correct`` when every number is finite and at or
    under its limit; ``checks`` maps each name to its value and limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = float(numbers.get(name, math.inf))
        checks[name] = {"value": value, "limit": float(limit)}
        ok = ok and math.isfinite(value) and value <= float(limit)
    return ok, checks
