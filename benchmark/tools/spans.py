#!/usr/bin/env python3
"""Reads a span export of the port (a run with ``ACMIL_TORCH_SPANS=<path>``,
``acmil_tpu_torch/utils/profiling.py``) and prints, one JSON line each,
every train epoch and then the whole stretch:

    ACMIL_TORCH_SPANS=chiprun_out/spans.json python3 benchmark/run.py ...
    python3 benchmark/tools/spans.py chiprun_out/spans.json

- an epoch (from one ``epoch.train`` span to the next): the train pass's
  host time split by its spans (``graph.replay``, ``sched.load``,
  ``epoch.sums``) and its own time, the evals' time, the rest, the card's
  time in the pass's replays and in the evals', the share of the epoch in
  which no ``graph.replay`` ran on the card, and those idle gaps summed by
  the innermost host span open at each gap's middle;
- the stretch: per span name its count, host, self and device seconds, the
  counters, and the readings ``replay_idle_share`` (% of the epochs' time
  with no replay on the card), ``replay_launch_us`` (a replay span's mean
  host time), ``mlp_half_ms_per_batch`` (``vit.mlp_half``'s device time a
  ``step2.encode`` batch) and ``h2d_host_ms_per_batch`` (``step2.h2d``'s
  host time a batch), each None where the stretch has none of its spans
  (no replay timed on a card, for the first).

The benchmark's own runs do none of this.
"""

import argparse
import bisect
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def load(path: str):
    """The records of an export (``profiling.Record``, in ns from the
    stretch's start), its counters and its window (ns)."""
    from acmil_tpu_torch.utils.profiling import Record

    with open(path) as f:
        trace = json.load(f)
    host, dev = {}, {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            (host if e["pid"] == 1 else dev)[e["args"]["index"]] = e
    ns = lambda us: round(us * 1e3)
    recs = []
    for i in range(len(host)):
        e, d = host[i], dev.get(i)
        recs.append(Record(e["name"], ns(e["ts"]), ns(e["ts"] + e["dur"]),
                           e["args"]["parent"], e["tid"],
                           ns(d["ts"]) if d else None,
                           ns(d["ts"] + d["dur"]) if d else None))
    other = trace["otherData"]
    return recs, other["counters"], ns(other["window_us"])


def busy_in(busy, lo: int, hi: int) -> int:
    return sum(min(e, hi) - max(s, lo) for s, e in busy if e > lo and s < hi)


def gaps(busy, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that ``busy`` (merged) leaves out."""
    edges = [lo]
    for s, e in busy:
        if e > lo and s < hi:
            edges += [max(s, lo), min(e, hi)]
    edges.append(hi)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def innermost(recs, starts: List[int], at: int) -> str:
    """The innermost span open at ``at``: the last to start before it or,
    if that one has ended, its nearest ancestor still open (spans of one
    thread nest)."""
    k = bisect.bisect_right(starts, at) - 1
    while k >= 0 and recs[k].end_ns <= at:
        k = recs[k].parent
    return recs[k].name if k >= 0 else "no span"


def replay_busy(recs) -> List[Tuple[int, int]]:
    """When some ``graph.replay`` ran on the card (merged intervals)."""
    from harness.trace import _merge

    return _merge((r.device_start_ns, r.device_end_ns) for r in recs
                  if r.name == "graph.replay"
                  and r.device_start_ns is not None)


def epochs(recs) -> List[dict]:
    """Each train epoch, from one ``epoch.train`` span's start to the next
    (the last to its evals' end): its train pass split by the pass's child
    spans and its own time, its evals, the rest (the caller's time between
    them), the card's time in the pass's replays and in the evals', the
    share of the epoch in which no replay ran on the card, and those gaps
    summed by the innermost span open at each gap's middle."""
    busy = replay_busy(recs)
    starts = [r.start_ns for r in recs]
    train = [i for i, r in enumerate(recs) if r.name == "epoch.train"]
    out = []
    for k, i in enumerate(train):
        t = recs[i]
        j = train[k + 1] if k + 1 < len(train) else len(recs)
        inside = recs[i:j]
        lo = t.start_ns
        hi = (recs[j].start_ns if j < len(recs) else
              max(r.end_ns for r in inside if r.parent < 0))
        split: Dict[str, float] = {}
        for r in inside:
            if r.parent == i:
                split[r.name] = split.get(r.name, 0.0) + (
                    r.end_ns - r.start_ns) / 1e6
        train_ms = (t.end_ns - t.start_ns) / 1e6
        split["own"] = train_ms - sum(split.values())
        evals = sum(r.end_ns - r.start_ns for r in inside
                    if r.name == "epoch.eval") / 1e6
        # the card's time in the pass's replays and in the evals'
        dev = [0.0, 0.0]
        for r in inside:
            if r.name == "graph.replay" and r.device_start_ns is not None:
                dev[r.parent != i] += (r.device_end_ns
                                       - r.device_start_ns) / 1e6
        idle: Dict[str, float] = {}
        for s, e in gaps(busy, lo, hi):
            name = innermost(recs, starts, (s + e) // 2)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        window = (hi - lo) / 1e6
        out.append({
            "epoch": k, "at_s": lo / 1e9, "ms": window,
            "train_ms": train_ms, "train_split_ms": split,
            "eval_ms": evals, "rest_ms": window - train_ms - evals,
            "train_replays_device_ms": dev[0],
            "eval_replays_device_ms": dev[1],
            "idle_pct": 100.0 * sum(idle.values()) / window,
            "train_idle_pct": 100.0 * (1 - busy_in(busy, t.start_ns,
                                                   t.end_ns) / 1e6
                                       / train_ms),
            "idle_ms_by_span": dict(sorted(idle.items(),
                                           key=lambda kv: -kv[1]))})
    return out


def readings(recs) -> Dict[str, Optional[float]]:
    """The four readings of the stretch, None where it has no spans for
    one."""
    by: Dict[str, list] = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    replays = by.get("graph.replay", [])
    ep = epochs(recs) if replay_busy(recs) else []
    window = sum(e["ms"] for e in ep)
    batches = len(by.get("step2.encode", []))
    mlp = [r for r in by.get("vit.mlp_half", [])
           if r.device_start_ns is not None]
    h2d = by.get("step2.h2d", [])
    return {
        "replay_idle_share": (sum(e["idle_pct"] * e["ms"] for e in ep)
                              / window if window else None),
        "replay_launch_us": (sum(r.end_ns - r.start_ns for r in replays)
                             / len(replays) / 1e3 if replays else None),
        "mlp_half_ms_per_batch": (
            sum(r.device_end_ns - r.device_start_ns for r in mlp)
            / batches / 1e6 if mlp and batches else None),
        "h2d_host_ms_per_batch": (
            sum(r.end_ns - r.start_ns for r in h2d) / len(h2d) / 1e6
            if h2d else None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("export")
    args = p.parse_args(argv)
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)
    from acmil_tpu_torch.utils.profiling import summary

    recs, counters, window = load(args.export)
    for e in epochs(recs):
        print(json.dumps(e))
    print(json.dumps({"window_s": window / 1e9, "spans": summary(recs),
                      "counters": counters, "readings": readings(recs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
