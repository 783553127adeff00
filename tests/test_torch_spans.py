"""The port's span and counter registry (``acmil_tpu_torch/utils/
profiling.py``): off, one shared no-op and nothing recorded; on, records
nested as the code nests them, with self times, counts and a fresh stretch
at ``reset()``; spans named on a ``torch.profiler``'s timeline; the Chrome
export of ``ACMIL_TORCH_SPANS``; and ``vit_encode``'s spans on its routes.
CPU and small shapes; the ``gpu`` cases (device-timed spans, CUDA graphs)
skip without a card. The file imports no JAX."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from acmil_tpu_torch.models.encoders.fast import vit_encode, vit_route
from acmil_tpu_torch.models.encoders.vit import ViT
from acmil_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.spans_on(False)
    profiling.reset()
    yield
    profiling.spans_on(False)
    profiling.reset()


def _spans_on():
    profiling.reset()
    profiling.spans_on(True)


def test_off_spans_are_one_shared_no_op_and_record_nothing():
    first = profiling.span("a")
    assert profiling.span("b", device=True) is first
    with first:
        with profiling.span("a"):
            profiling.count("n", 3)
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["records"] == []


def test_on_spans_nest_with_parents_self_time_and_counts():
    _spans_on()
    with profiling.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with profiling.span("inner"):
                time.sleep(0.01)
                profiling.count("items", 2)
    with profiling.span("outer"):
        pass
    snap = profiling.snapshot()
    recs = snap["records"]
    assert [r.name for r in recs] == ["outer", "inner", "inner", "outer"]
    assert [r.parent for r in recs] == [-1, 0, 0, -1]
    for r in recs:
        assert snap["window_ns"][0] <= r.start_ns <= r.end_ns \
            <= snap["window_ns"][1]
        assert r.device_start_ns is None        # no card: host time only
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["count"] == 2 and inner["count"] == 2
    assert inner["host_s"] >= 0.02 and outer["host_s"] >= 0.04
    children = sum(r.end_ns - r.start_ns for r in recs[1:3]) / 1e9
    assert outer["self_s"] == pytest.approx(outer["host_s"] - children)
    assert inner["self_s"] == pytest.approx(inner["host_s"])
    assert "device_s" not in outer
    assert snap["counters"] == {"items": 4}
    profiling.reset()
    with profiling.span("later"):
        pass
    snap = profiling.snapshot()
    assert list(snap["spans"]) == ["later"] and snap["counters"] == {}
    assert snap["records"][0].parent == -1


def test_counter_sources_give_their_growth_over_the_stretch():
    totals = {"things": 5}
    profiling.counter_source(totals.copy)
    _spans_on()                        # reset: the baseline is 5
    assert profiling.snapshot()["counters"] == {}
    totals["things"] = 12
    assert profiling.snapshot()["counters"] == {"things": 7}


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_user_annotations_under_the_profiler(on):
    from torch.profiler import ProfilerActivity, profile

    profiling.spans_on(on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("layer.outer"):
            with profiling.span("layer.inner", device=True):
                torch.ones(8) + 1
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"layer.outer", "layer.inner"} <= names
    assert bool(profiling.snapshot()["records"]) is on


def test_chrome_export_parses_on_one_timeline(tmp_path):
    _spans_on()
    with profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("items")
    path = tmp_path / "spans.json"
    profiling._REGISTRY.export(str(path))
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["outer", "inner"]
    assert {e["pid"] for e in spans} == {1}
    assert spans[1]["args"] == {"index": 1, "parent": 0}
    assert 0 <= spans[0]["ts"] <= spans[1]["ts"]
    assert spans[1]["ts"] + spans[1]["dur"] <= spans[0]["ts"] \
        + spans[0]["dur"] <= trace["otherData"]["window_us"]
    assert trace["otherData"]["counters"] == {"items": 1}


def test_the_environment_switch_exports_at_exit(tmp_path):
    """``ACMIL_TORCH_SPANS`` turns spans on at import and writes the
    stretch when the interpreter exits."""
    path = tmp_path / "run.json"
    code = ("from acmil_tpu_torch.utils import profiling\n"
            "with profiling.span('work'):\n"
            "    profiling.count('items', 2)\n")
    env = dict(os.environ, ACMIL_TORCH_SPANS=str(path))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    trace = json.loads(path.read_text())
    assert [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"] \
        == ["work"]
    assert trace["otherData"]["counters"] == {"items": 2}


# the CPU's plain route of the whole-layer trunk (B3's) and of the
# attention-half trunk (B4's, with layerscale), at tiny widths
TRUNKS = {
    "layer": dict(patch=16, dim=64, depth=2, heads=2, img_size=32),
    "half": dict(patch=16, dim=96, depth=3, heads=4, layerscale=True,
                 img_size=32),
}


@pytest.mark.parametrize("route", sorted(TRUNKS))
def test_vit_encode_spans_each_block_on_its_route(route):
    kw = TRUNKS[route]
    torch.manual_seed(0)
    vit = ViT(**kw)
    sd = {k: v.detach() for k, v in vit.state_dict().items()}
    assert vit_route(sd, 5, vit.heads, torch.float32, vit.act) == route
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    enc = dict(patch=vit.patch, depth=vit.depth, heads=vit.heads,
               dtype=torch.float32, act=vit.act)
    want = vit_encode(sd, x, **enc)
    _spans_on()
    batches = 2
    for _ in range(batches):
        got = vit_encode(sd, x, **enc)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    counts = {k: v["count"] for k, v in profiling.snapshot()["spans"].items()}
    blocks = ({"vit.layer": kw["depth"] * batches} if route == "layer" else
              {"vit.attn_half": kw["depth"] * batches,
               "vit.mlp_half": kw["depth"] * batches})
    assert counts == dict(blocks, **{"vit.embed": batches,
                                     "vit.head": batches})


def test_step2_batch_spans_nest_inside_the_encode_span():
    from types import SimpleNamespace

    from acmil_tpu_torch.models.encoders.build import (CustomModel,
                                                       encoder_feature_fn)

    torch.manual_seed(0)
    model = CustomModel(ViT(**TRUNKS["layer"]), 2)
    spec = SimpleNamespace(mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25))
    feat_fn = encoder_feature_fn(model, spec, torch.device("cpu"),
                                 out_dtype=torch.float32)
    pixels = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    _spans_on()
    feats = feat_fn(pixels)
    assert feats.shape == (3, 64)
    recs = profiling.snapshot()["records"]
    assert recs[0].name == "step2.encode" and recs[0].parent == -1
    assert [r.name for r in recs[1:3]] == ["step2.h2d", "vit.embed"]
    assert {r.parent for r in recs[1:]} == {0}
    assert [r.name for r in recs].count("vit.layer") == 2


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("device-timed spans and CUDA graphs need an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_epoch_same_bits_with_spans_on_and_off(cuda_device):
    """One scanned ACMIL_GA epoch on the graph route with spans off and
    with them on: the same parameters and sums, bit for bit; each replay a
    device-timed span inside the stretch, and the graphs' counters
    carried by the snapshot."""
    from test_torch_gpu_scan_epoch import _conf, _epoch

    from acmil_tpu_torch.models import build_mil_model

    conf = _conf("ga")
    torch.manual_seed(0)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    m_off, st_off, stats_off, _ = _epoch(conf, model, family, "graph",
                                         cuda_device)
    _spans_on()
    m_on, st_on, stats_on, scan = _epoch(conf, model, family, "graph",
                                         cuda_device)
    snap = profiling.snapshot()
    for (name, p), q in zip(m_on.named_parameters(), m_off.parameters()):
        assert torch.equal(p, q), name
    assert stats_on == stats_off and st_on.step == st_off.step > 0
    lo, hi = snap["window_ns"]
    replays = [r for r in snap["records"] if r.name == "graph.replay"]
    assert len(replays) == st_on.step
    for r in replays:
        assert lo <= r.device_start_ns <= r.device_end_ns <= hi
    assert snap["spans"]["graph.replay"]["device_s"] > 0
    counters = snap["counters"]
    assert counters["graph.replays"] == st_on.step
    assert counters["graph.launches.B1"] == counters["graph.launches.B2"] \
        == st_on.step
    assert counters["graph.capture_s"] > 0
    assert snap["spans"]["graph.capture"]["count"] == len(
        scan.graphs.replays)
    assert snap["spans"]["epoch.sums"]["count"] == 1


@pytest.mark.gpu
def test_device_span_inside_a_capture_records_host_time_only(cuda_device):
    x = torch.ones(1024, device=cuda_device)
    _spans_on()
    with profiling.span("eager", device=True):
        x.mul_(2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with profiling.span("captured", device=True):
            x.add_(1)
    graph.replay()
    snap = profiling.snapshot()
    by = {r.name: r for r in snap["records"]}
    assert by["captured"].device_start_ns is None
    lo, hi = snap["window_ns"]
    assert lo <= by["eager"].device_start_ns <= by["eager"].device_end_ns \
        <= hi
    assert x[0].item() == 3.0
