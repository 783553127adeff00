"""``tools/spans.py`` reads a span export of the port: records back as the
program kept them, a train epoch split by span with its replay-idle gaps
named by the innermost host span, and the stretch's four readings, on an
export written by hand and on one written by the program."""

import json
import os

import pytest

from conftest import BENCH
from harness.spec import load_path

spans = load_path(os.path.join(BENCH, "tools", "spans.py"))
MS = 1_000_000


def _write(tmp_path, records, counters=None):
    """An export as ``profiling.Registry.export`` writes one, from
    (name, start, end, parent, device start, device end) in ms."""
    events = []
    for i, (name, s, e, parent, ds, de) in enumerate(records):
        args = {"index": i, "parent": parent}
        events.append({"name": name, "ph": "X", "pid": 1, "tid": 7,
                       "ts": s * 1e3, "dur": (e - s) * 1e3, "args": args})
        if ds is not None:
            events.append({"name": name, "ph": "X", "pid": 2, "tid": 0,
                           "ts": ds * 1e3, "dur": (de - ds) * 1e3,
                           "args": args})
    path = tmp_path / "spans.json"
    path.write_text(json.dumps({
        "traceEvents": events, "otherData": {
            "counters": counters or {}, "t0_ns": 0,
            "window_us": max(r[2] for r in records) * 1e3}}))
    return str(path)


# two epochs of 10 ms: a schedule load, two replays (each 3 ms on the
# card), the sums' read-back, then an eval of one replay and its gather
EPOCHS = [
    ("epoch.train", 0, 7, -1, None, None),
    ("sched.load", 0, 1, 0, None, None),
    ("graph.replay", 1, 2, 0, 1, 4),
    ("graph.replay", 2, 3, 0, 4, 7),
    ("epoch.sums", 3, 7, 0, None, None),
    ("epoch.eval", 7, 10, -1, None, None),
    ("graph.replay", 7, 8, 5, 7, 9),
    ("eval.gather", 8, 10, 5, None, None),
    ("epoch.train", 10, 17, -1, None, None),
    ("sched.load", 10, 12, 8, None, None),
    ("graph.replay", 12, 13, 8, 12, 15),
    ("graph.replay", 13, 14, 8, 15, 17),
    ("epoch.sums", 14, 17, 8, None, None),
    ("epoch.eval", 17, 20, -1, None, None),
    ("graph.replay", 17, 18, 13, 17, 19),
    ("eval.gather", 18, 20, 13, None, None),
]


def test_an_export_loads_back_as_records(tmp_path):
    recs, counters, window = spans.load(_write(tmp_path, EPOCHS,
                                               {"graph.replays": 6}))
    assert len(recs) == len(EPOCHS) and window == 20 * MS
    assert counters == {"graph.replays": 6}
    r = recs[2]
    assert (r.name, r.start_ns, r.end_ns, r.parent, r.device_start_ns,
            r.device_end_ns) == ("graph.replay", MS, 2 * MS, 0, MS, 4 * MS)
    assert recs[1].device_start_ns is None


def test_epochs_split_by_span_and_idle_gaps_named(tmp_path):
    recs, _, _ = spans.load(_write(tmp_path, EPOCHS))
    first, second = spans.epochs(recs)
    assert first["ms"] == pytest.approx(10) and second["ms"] == \
        pytest.approx(10)
    assert first["train_split_ms"] == pytest.approx(
        {"sched.load": 1, "graph.replay": 2, "epoch.sums": 4, "own": 0})
    assert first["eval_ms"] == pytest.approx(3)
    assert first["train_replays_device_ms"] == pytest.approx(6)
    assert first["eval_replays_device_ms"] == pytest.approx(2)
    assert first["rest_ms"] == pytest.approx(0)
    # idle on the card: 0-1 (sched.load), 9-10 (eval.gather)
    assert first["idle_ms_by_span"] == pytest.approx(
        {"sched.load": 1, "eval.gather": 1})
    assert first["idle_pct"] == pytest.approx(20)
    assert first["train_idle_pct"] == pytest.approx(100 / 7)
    # 10-12 (sched.load), 19-20 (eval.gather)
    assert second["idle_ms_by_span"] == pytest.approx(
        {"sched.load": 2, "eval.gather": 1})


def test_readings_of_a_train_stretch(tmp_path):
    recs, _, _ = spans.load(_write(tmp_path, EPOCHS))
    got = spans.readings(recs)
    assert got["replay_idle_share"] == pytest.approx(25)
    assert got["replay_launch_us"] == pytest.approx(1000)
    assert got["mlp_half_ms_per_batch"] is None
    assert got["h2d_host_ms_per_batch"] is None


def test_readings_of_an_extract_stretch(tmp_path):
    batch = [("step2.encode", 0, 10, -1, 0, 12),
             ("step2.h2d", 0, 2, 0, None, None),
             ("vit.attn_half", 2, 3, 0, 2, 5),
             ("vit.mlp_half", 3, 4, 0, 5, 9),
             ("vit.attn_half", 4, 5, 0, 9, 10),
             ("vit.mlp_half", 5, 6, 0, 10, 12)]
    two = batch + [(n, s + 20, e + 20, p + 6 if p >= 0 else -1,
                    None if ds is None else ds + 20,
                    None if de is None else de + 20)
                   for n, s, e, p, ds, de in batch]
    recs, _, _ = spans.load(_write(tmp_path, two))
    got = spans.readings(recs)
    assert got["mlp_half_ms_per_batch"] == pytest.approx(6)
    assert got["h2d_host_ms_per_batch"] == pytest.approx(2)
    assert got["replay_idle_share"] is None
    assert got["replay_launch_us"] is None


def test_the_programs_own_export_reads_back(tmp_path):
    from acmil_tpu_torch.utils import profiling

    profiling.reset()
    profiling.spans_on(True)
    try:
        with profiling.span("epoch.train"):
            with profiling.span("sched.load"):
                pass
            profiling.count("items", 3)
        with profiling.span("epoch.eval"):
            pass
        snap = profiling.snapshot()
        path = tmp_path / "program.json"
        profiling._REGISTRY.export(str(path))
    finally:
        profiling.spans_on(False)
        profiling.reset()
    recs, counters, _ = spans.load(str(path))
    assert counters == {"items": 3}
    t0 = snap["window_ns"][0]
    assert [(r.name, r.parent) for r in recs] == [
        (r.name, r.parent) for r in snap["records"]]
    for got, want in zip(recs, snap["records"]):
        assert abs(got.start_ns - (want.start_ns - t0)) <= 1
    (epoch,) = spans.epochs(recs)
    assert set(epoch["train_split_ms"]) == {"sched.load", "own"}
    assert profiling.summary(recs).keys() == snap["spans"].keys()
