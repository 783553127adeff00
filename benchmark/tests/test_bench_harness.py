"""The harness finds everything by name, its generators repeat per seed,
its work counts match hand counts, and its trace arithmetic holds."""

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(load, name):
    from harness.spec import kernel_table, metric_reader

    cell = load(name)
    assert cell.kind in ("train", "extract")
    assert hasattr(cell.kind_module(), "run")
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    # the counts are exact; every gap of a reading has room above 0
    exact = {"step_count_gap", "eval_count_gap", "answer_count_gap",
             "leaf_change_off"}
    assert all(v > 0 for k, v in cell.limits.items() if k not in exact)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]).read)
    for part in cell.config["reference"]:
        assert hasattr(cell.reference(part), "__file__")
    for f in os.listdir(os.path.join(BENCH, "kernels")):
        assert kernel_table(f[:-5])["match"]


def test_unknown_workload_is_refused():
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "no_such_cell", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0 and not r.stdout.strip()


def test_no_card_no_result():
    """On a machine without a card the run fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "train_vits16_acmil", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0 and not r.stdout.strip()


def test_cohort_sizes_fixed_and_inputs_repeat_per_seed(tiny_cell):
    cell = tiny_cell("train_vits16_acmil")
    kind = cell.kind_module()
    cpu = torch.device("cpu")
    a, b, c = (kind.Inputs(cell, s, cpu) for s in (7, 7, 2 ** 31 + 9))
    for s in ("train", "val", "test"):
        la = sorted(n for ls in a.splits[s].lengths for n in ls)
        lc = sorted(n for ls in c.splits[s].lengths for n in ls)
        assert la == lc                    # the same sizes for every seed
        for ga, gb in zip(a.splits[s].groups, b.splits[s].groups):
            assert torch.equal(ga.feats, gb.feats)
            assert torch.equal(ga.mask, gb.mask)
    assert a.picks == b.picks
    fa = torch.cat([g.feats.flatten() for g in a.splits["train"].groups])
    fc = torch.cat([g.feats.flatten() for g in c.splits["train"].groups])
    assert not torch.equal(fa, fc)


def test_cohort_has_the_published_mean(load):
    traffic = load("train_vits16_acmil").traffic
    lens = load("train_vits16_acmil").kind_module().cohort_lengths(traffic)
    assert [len(lens[s]) for s in ("train", "val", "test")] == [242, 27, 129]
    allv = np.concatenate(list(lens.values()))
    assert allv.min() >= 500 and allv.max() <= traffic["max_patches"]
    # about 8,000 patches a Camelyon16 slide (the mix's source)
    assert 7000 < allv.mean() < 9000 and 5000 < np.median(allv) < 7000


def test_pixels_repeat_per_seed(tiny_cell):
    cell = tiny_cell("extract_uni")
    kind = cell.kind_module()
    cpu = torch.device("cpu")
    a, b, c = (kind.Inputs(cell, s, cpu) for s in (3, 3, 4))
    assert all(np.array_equal(x, y) for x, y in zip(a.pool, b.pool))
    assert not np.array_equal(a.pool[0], c.pool[0])
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert a.pool[0].dtype == np.uint8 and a.pool[0].shape == (2, 224, 224, 3)
    assert a.sample(2) == b.sample(2)


def test_attn_pool_work_by_hand():
    from harness.spec import flops

    f = flops("acmil_ga")
    n, df, l, a, k = 1000, 384, 128, 128, 5
    ops, nbytes = f.b1(n, df, l, a, k)
    # x W1, V and U, the logits, the pooling: 2 x multiply-adds
    assert ops == 2 * 1000 * (384 * 128 + 2 * 128 * 128 + 128 * 5 + 5 * 128)
    weights = 384 * 128 + 128 + 2 * (128 * 128 + 128) + 128 * 5 + 5
    assert nbytes == 1000 * 384 * 2 + 1000 + 4 * weights + 4 * (
        5 * 1000 + 5 * 128 + 2 * 5)
    ops2, _ = f.b2(n, df, l, a, k)
    assert ops2 == 2 * 1000 * (2 * 384 * 128 + 6 * 128 * 128 + 3 * 128 * 5
                               + 2 * 128 * 5)
    assert f.bound_s(1e12, 1.0, 1e12, 1e9) == 1.0
    assert f.bound_s(1.0, 3.35e12, 1e15, 3.35e12) == 1.0
    fwd = f.eval_flops(n, df, l, a, k, 2)
    assert fwd == ops + 2 * 6 * 128 * 2
    assert f.train_flops(n, df, l, a, k, 2) == fwd + (
        2 * 1000 * 384 * 128 + 2 * 2 * 1000 * (2 * 128 * 128 + 128 * 5
                                               + 5 * 128) + 2 * 2 * 6 * 128 * 2)


def test_vit_work_by_hand():
    from harness.spec import flops

    v = flops("vit")
    n = 197
    # ViT-S/16: patch embed + 12 x (qkv, q k^T, p v, proj, fc1, fc2)
    want = 2 * n * 384 * 768 + 12 * (
        2 * n * 384 * 1152 + 4 * n * n * 384 + 2 * n * 384 * 384
        + 4 * n * 384 * 1536)
    assert v.flops_per_image(224, 16, 384, 12, 1536) == want
    assert abs(want / 1e9 - 9.2) < 0.1
    ops, nbytes = v.linear_work(224, 16, 384, 1, 1536, images=2)
    assert ops == 2 * 2 * n * (384 * 1152 + 384 * 384 + 2 * 384 * 1536)
    assert nbytes == 2 * sum(m * k * 2 + k * o + m * o * 2 for m, k, o in
                             ((n, 384, 1152), (n, 384, 384),
                              (n, 384, 1536), (n, 1536, 384)))
    ops, nbytes = v.attention_work(224, 16, 384, 12, images=1)
    assert ops == 4 * n * n * 384 * 12 and nbytes == 4 * n * 384 * 2 * 12


@pytest.mark.parametrize("family,name,want", [
    ("vit_linear", "void (anonymous namespace)::gemm_kernel<__nv_bfloat16, "
     "2>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::EpilogueArgs,"
     " int, int, int)", True),
    ("vit_linear", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_"
     "stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
     True),
    ("vit_linear", "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_"
     "nt_align1>(cutlass_80_simt_sgemm_256x128_8x4_nt_align1::Params)", True),
    ("vit_linear", "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_"
     "s16816fprop_optimized_bf16_128x128_32x4_nhwc_align8>(...)", False),
    ("vit_linear", "void (anonymous namespace)::ln_rows_kernel<float, "
     "__nv_bfloat16, true>(float const*)", False),
    ("vit_attn", "void (anonymous namespace)::mha_kernel<__nv_bfloat16, 64,"
     " 1>((anonymous namespace)::Strided<__nv_bfloat16 const>)", True),
    ("attn_pool", "void (anonymous namespace)::gated_h::gated_h_kernel<"
     "__half, false>(__half const*)", True),
    ("attn_pool", "void (anonymous namespace)::b2_wgrad_kernel<__half>("
     "__half const*)", True),
    ("attn_pool", "void at::native::sbtopk::gatherTopK<float>()", False),
])
def test_kernel_tables(family, name, want):
    from harness.spec import in_family, kernel_table

    assert in_family(kernel_table(family), name) is want


def test_rounding_controls():
    from harness.precision import fp8, tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((fp8(y) - y).norm() / y.norm()).item()
    assert 1e-3 < rel < 0.1
    rel = ((tf32(y) - y).norm() / y.norm()).item()
    assert 1e-5 < rel < 1e-3


def test_gaps_and_judgement():
    from harness.checks import judge, leaf_gap, moving_leaves, rel_gap

    assert rel_gap(1.1, 1.0) == pytest.approx(0.1)
    assert rel_gap(float("nan"), 1.0) == math.inf
    want = {"a": torch.ones(4), "b": torch.full((4,), 2.0),
            "c": torch.zeros(4) + 1e-9}
    got = {"a": torch.ones(4) * 1.1, "b": torch.full((4,), 2.0),
           "c": torch.zeros(4)}
    gap, at = leaf_gap(got, want)
    assert at == "a" and gap == pytest.approx(0.1)
    assert moving_leaves(want) == ["a", "b"]
    ok, checks = judge({"x": 1.0, "y": 3.0}, {"x": 2.0, "y": 2.0})
    assert not ok and checks["y"] == {"value": 3.0, "limit": 2.0}
    ok, _ = judge({"x": float("nan")}, {"x": 2.0})
    assert not ok


def test_trace_busy_and_gaps():
    from harness.trace import DeviceOp, TraceData, _merge, breakdown

    ops = [DeviceOp("k1", 0, 10), DeviceOp("k2", 5, 20),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", 40, 50)]
    busy = _merge((o.start_ns, o.end_ns) for o in ops)
    assert busy == [(0, 20), (40, 50)]
    host = [("bench.window", 0, 100, True), ("aten::copy_", 18, 45, False)]
    data = TraceData(ops, host, (0, 100), busy, 100e-9)
    assert data.busy_s == pytest.approx(30e-9)
    assert ops[2].kind == "memcpy" and ops[0].kind == "kernel"
    out = breakdown(data, data)
    assert out["idle_gaps"][0] == ["bench.window", pytest.approx(50e-9)]
    assert out["idle_gaps"][1] == ["bench.window / aten::copy_",
                                   pytest.approx(20e-9)]
    assert out["device_ops"][0][0] == "k2"


def test_readers_on_a_synthetic_trace(load):
    """Each per-layer reader reads a number of the right kind from a trace
    built by hand, and a share of a roofline is never above 100%."""
    from harness.common import Context
    from harness.spec import metric_reader
    from harness.trace import DeviceOp, TraceData

    b1 = "void (anonymous namespace)::b1_row_kernel<128>(float const*)"
    gemm = "void (anonymous namespace)::gemm_kernel<__nv_bfloat16, 0>()"
    mha = "void (anonymous namespace)::mha_kernel<__nv_bfloat16, 64, 1>()"
    ops = [DeviceOp(b1, 0, 10 ** 9), DeviceOp("other_kernel", 10 ** 9,
                                              2 * 10 ** 9),
           DeviceOp(gemm, 2 * 10 ** 9, 3 * 10 ** 9),
           DeviceOp(mha, 3 * 10 ** 9, 4 * 10 ** 9),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", 4 * 10 ** 9,
                    5 * 10 ** 9)]
    data = TraceData(ops, [], (0, 10 ** 10), [(0, 5 * 10 ** 9)], 10.0)
    works = {"train": {"epochs": 1, "train_lengths": [3000] * 242,
                       "eval_lengths": [3000] * 156, "capture_s": 0.5},
             "extract": {"batches": 10, "batch_size": 256}}
    for name in ("train_vits16_acmil", "extract_uni"):
        cell = load(name)
        ctx = Context(data, cell, works[cell.kind], "NVIDIA H100 80GB HBM3")
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            assert value is not None and math.isfinite(value), m["name"]
            if m["unit"] == "%":
                assert 0 <= value <= 100, (m["name"], value)
    assert metric_reader("idle_share.extract").read(ctx) == 50.0


def test_per_layer_metric_without_workloads_follows_moves(tmp_path):
    """A per-layer metric that lists no cells is read in every cell that
    reports the end-to-end metric it moves, as the contract has it."""
    from harness.spec import load_cell

    b = bench()
    for c in b["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    b["per_layer"].append({"name": "later_metric", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_epoch_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    for w in b["workloads"]:
        cell = load_cell(str(tmp_path), w["name"])
        names = {m["name"] for m in cell.per_layer}
        assert ("later_metric" in names) is (cell.kind == "train")
