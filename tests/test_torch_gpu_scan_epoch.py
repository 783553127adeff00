"""The scanned epoch's CUDA graph route (``engine/train.py``,
``engine/graphs.py``) against its eager scanned route, on a card. The file
imports no JAX; its ``gpu`` tests skip without a card, and
tests/test_torch_scan_epoch.py holds the eager route against JAX and
against the per-bag loop on the CPU.

At small shapes, each arch of the registry, and the kernels' archs with
SAM, trains one epoch on both routes from the same weights, in the same
visit order with the same draws, and the parameters (MHIM's teacher too),
the step and the epoch's sums must agree bit for bit; a SAM replay launches
B1 and B2 twice, a fused DTFD replay once; the scanned eval must equal
``evaluate``. A capture that fails raises
and leaves no eager fallback behind, and the replays' count times the
launches of one capture equals the kernels the profiler sees. On an NCCL
mesh of one process the scanned step takes the graph route and equals one
process's, bit for bit."""

import copy

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import BagLoader
from acmil_tpu_torch.engine import get_family
from acmil_tpu_torch.engine.train import (GRAPH_SCAN_ARCHS,
                                          create_train_state, evaluate,
                                          evaluate_scanned, make_eval_step,
                                          make_scan_eval_step,
                                          make_scan_train_step,
                                          train_one_epoch_scanned)
from acmil_tpu_torch.models import build_mil_model, fast
from acmil_tpu_torch.ops import attn_pool as ap
from acmil_tpu_torch.ops import dsmil_pool

GRAPH_ARCHS = ("ga", "mha", "abmil", "clam_sb", "clam_mb", "dsmil")
# SAM ("+sam"), DTFD on B1/B2 ("+fused", DTFD_FUSE_MIN_S pinned to 0) and
# the other families
NEW_CASES = tuple(a + "+sam" for a in GRAPH_ARCHS) + (
    "dtfd+fused", "dtfd+fused+sam") + tuple(
    a for a in GRAPH_SCAN_ARCHS if a not in GRAPH_ARCHS)
# the archs whose train step runs B1 and B2
B1_B2 = ("ga", "clam_sb", "clam_mb")
D_FEAT, D_INNER = 64, 128


class _Source:
    """In-RAM bags: lengths 40-700 in three buckets of 256."""

    def __init__(self, n=12, seed=0):
        rs = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            m = int(rs.randint(40, 700))
            feats = rs.randn(m, D_FEAT).astype(np.float32)
            feats[: m // 10] += 2.0 * (i % 2)
            self.items.append({"input": feats, "label": i % 2,
                               "coords": rs.randint(0, 5000, (m, 2))})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it["input"]) for it in self.items]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs of the scanned step need an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same_metrics(got, want):
    """Equal metrics; the loss is a mean over the bags taken in another
    order, equal to 1e-12 relative."""
    assert got.keys() == want.keys()
    for k in got:
        if k == "loss":
            assert got[k] == pytest.approx(want[k], rel=1e-12)
        else:
            assert got[k] == want[k] or (np.isnan(got[k]) and
                                         np.isnan(want[k])), k


def _conf(arch, **kw):
    """``arch`` may carry options: ``+sam`` (use_sam), ``+fused`` (DTFD
    without dropout, to take B1/B2 where DTFD_FUSE_MIN_S routes)."""
    arch, *opts = arch.split("+")
    fused = arch in B1_B2 or "fused" in opts
    d = dict(n_class=2, D_feat=D_FEAT, D_inner=D_INNER, n_token=3,
             n_masked_patch=10, mask_drop=0.6, lr=1e-3, wd=1e-5,
             train_epoch=4, warmup_epoch=1, min_bucket=256, seed=0, arch=arch,
             droprate=0.0 if fused else 0.25, use_sam="sam" in opts,
             dropout=0.25, mlp_dim=64, mask_ratio=0.1, mask_ratio_h=0.2,
             mask_ratio_hr=0.5, mm=0.9, mm_sche=True, mrh_sche=True,
             steps_per_epoch=12, ips_m=64, numGroup=4, total_instance=4)
    d.update(kw)
    return Config.from_dict(d)


def _loader(device, shuffle=True, mesh=None):
    return BagLoader(_Source(), 1, shuffle=shuffle, drop_last=shuffle,
                     min_bucket=256, seed=0, dtype=np.float16, device=device,
                     mesh=mesh)


def _epoch(conf, model, family, route, device, mesh=None):
    """One scanned epoch on ``route`` (None: ``scan_route``'s), on
    ``mesh``: (state, stats, scan step)."""
    model = copy.deepcopy(model)
    loader = _loader(device, mesh=mesh)
    state = create_train_state(model, conf, len(loader), family=family)
    scan = make_scan_train_step(model, conf, family, mesh=mesh, route=route)
    assert scan.route == (route or "graph"), scan.reason
    torch.cuda.manual_seed(21)
    _, stats = train_one_epoch_scanned(state, scan, loader, 0, interleave=2)
    torch.cuda.synchronize()
    return model, state, stats, scan


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS + NEW_CASES)
def test_graph_route_equals_the_eager_scanned_route(cuda_device, arch,
                                                    monkeypatch):
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)      # CLAM and DSMIL fused
    monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", 0)
    conf = _conf(arch)
    name = arch.split("+")[0]
    kernels = name in B1_B2 or "fused" in arch
    torch.manual_seed(0)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    m_e, st_e, stats_e, _ = _epoch(conf, model, family, "eager", cuda_device)
    b1, b2 = ap.fused_gated_attn_pool_batched.launches, \
        ap.fused_gated_attn_pool_bwd.launches
    m_g, st_g, stats_g, scan = _epoch(conf, model, family, "graph",
                                      cuda_device)
    assert st_g.step == st_e.step > 0
    for (name, p), q in zip(m_g.named_parameters(), m_e.parameters()):
        assert torch.equal(p, q), name
    if st_g.teacher is not None:
        for (name, p), q in zip(st_g.teacher.named_parameters(),
                                st_e.teacher.parameters()):
            assert torch.equal(p, q), "teacher " + name
    assert stats_g == stats_e
    launched = scan.kernel_launches()
    assert sum(scan.graphs.replays.values()) == st_g.step
    # a SAM step runs each kernel in both passes
    per_step = (2 if conf.use_sam else 1) if kernels else 0
    assert launched.get("B1", 0) == launched.get("B2", 0) \
        == per_step * st_g.step
    # the warm-up launches once per group and pass; the captures nothing
    groups = len(scan.graphs.replays)
    assert ap.fused_gated_attn_pool_batched.launches - b1 == per_step * groups
    assert ap.fused_gated_attn_pool_bwd.launches - b2 == per_step * groups


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS + tuple(
    a for a in GRAPH_SCAN_ARCHS if a not in GRAPH_ARCHS) + ("dtfd+fused",))
def test_scanned_eval_graph_equals_evaluate(cuda_device, arch, monkeypatch):
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)      # B6 for DSMIL
    monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", 0)
    conf = _conf(arch)
    torch.manual_seed(1)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    want = evaluate(make_eval_step(model, family), _loader(cuda_device, False),
                    conf.n_class)
    scan_eval = make_scan_eval_step(model, family, route="graph")
    b6 = dsmil_pool.fused_dsmil_pool.launches
    got = evaluate_scanned(scan_eval, _loader(cuda_device, False),
                           conf.n_class)
    _same_metrics(got, want)
    if arch == "dsmil":
        groups = len(scan_eval.graphs.replays)
        assert scan_eval.kernel_launches()["B6"] == len(_Source())
        assert dsmil_pool.fused_dsmil_pool.launches - b6 == groups


@pytest.mark.gpu
@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_mhim_teacher_after_graph_epochs_equals_the_eager_one(cuda_device,
                                                              baseline):
    """Two epochs of MHIM on each route, the momentum and the mask ratio
    from their device tables: the teacher, which the graph's warm-up moved
    and put back, equals the eager route's bit for bit after each epoch, and
    has moved from the student's start."""
    conf = _conf("mhim", baseline=baseline)
    torch.manual_seed(5)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    start = copy.deepcopy(model.state_dict())
    runs = {}
    for route in ("eager", "graph"):
        m = copy.deepcopy(model)
        loader = _loader(cuda_device)
        state = create_train_state(m, conf, len(loader), family=family)
        scan = make_scan_train_step(m, conf, family, route=route)
        torch.cuda.manual_seed(21)
        teachers = []
        for epoch in range(2):
            train_one_epoch_scanned(state, scan, loader, epoch)
            torch.cuda.synchronize()
            teachers.append({k: v.clone() for k, v in
                             state.teacher.state_dict().items()})
        runs[route] = (state, teachers)
    assert runs["graph"][0].step == runs["eager"][0].step == 2 * len(
        _loader(cuda_device))
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    moved = [k for k in start if not torch.equal(
        runs["graph"][1][-1][k], start[k])]
    assert moved, "the teacher did not move"


@pytest.mark.gpu
def test_spvis_cell_gather_backward_gives_the_same_bits(cuda_device):
    """BMIL spvis's gather of each patch's cell, its backward over a bag
    whose 20000 patches share a few cells (atomics would add them in any
    order): the same bits on every run and in a graph replay, and the
    gather's own gradient to float32's rounding."""
    from acmil_tpu_torch.models.bmil import _CellGather

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(2, 4096, device=cuda_device, generator=gen,
                    requires_grad=True)
    cell = torch.randint(0, 3, (2, 20000), device=cuda_device, generator=gen)
    g = torch.randn(2, 20000, device=cuda_device, generator=gen)

    def grad():
        (got,) = torch.autograd.grad((_CellGather.apply(a, cell) * g).sum(),
                                     [a])
        return got

    first = grad()
    assert all(torch.equal(grad(), first) for _ in range(3))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = grad()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    (want,) = torch.autograd.grad((torch.gather(a, 1, cell) * g).sum(), [a])
    torch.testing.assert_close(first, want, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_replays_times_launches_equal_the_profiled_kernels(cuda_device):
    """The first epoch (warm-ups and captures) runs in the schedule's
    warm-up step, the second, replays only, in its active step."""
    conf = _conf("ga")
    torch.manual_seed(2)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    loader = _loader(cuda_device)
    state = create_train_state(model, conf, len(loader), family=family)
    scan = make_scan_train_step(model, conf, family)
    assert scan.route == "graph"
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA], schedule=sched) as prof:
        for epoch in range(2):
            if epoch == 1:
                before = dict(scan.kernel_launches())
            train_one_epoch_scanned(state, scan, loader, epoch)
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda k: sum(k in n for n in names)      # names are signatures
    after = scan.kernel_launches()
    assert after["B1"] - before["B1"] == after["B2"] - before["B2"] \
        == len(loader)
    # the tracer loses a kernel event now and then, of any route: one at most
    for k in ("b1_row_kernel", "b2_wgrad_kernel"):
        assert 0 <= len(loader) - count(k) <= 1, (k, count(k))


@pytest.mark.gpu
def test_a_failed_capture_raises_and_does_not_fall_back(cuda_device,
                                                        monkeypatch):
    conf = _conf("abmil")
    torch.manual_seed(3)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    fam = get_family(family)
    real = type(fam).loss

    def syncing(self, outputs, bag, valid, conf_d):
        loss, aux = real(self, outputs, bag, valid, conf_d)
        float(loss.detach())                     # a host sync: no capture
        return loss, aux

    monkeypatch.setattr(type(fam), "loss", syncing)
    loader = _loader(cuda_device)
    state = create_train_state(model, conf, len(loader), family=family)
    scan = make_scan_train_step(model, conf, family)
    with pytest.raises(RuntimeError):
        train_one_epoch_scanned(state, scan, loader, 0)
    assert scan.route == "graph" and not scan.graphs.replays
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["ga", "dsmil"])
def test_nccl_world_1_mesh_graph_route_equals_one_process(cuda_device, arch,
                                                          tmp_path,
                                                          monkeypatch):
    """``--scan_epoch --mesh_data 1`` under torchrun: an NCCL mesh of one
    process takes the graph route (``scan_route``), and its epoch and
    scanned eval equal one process's graph route bit for bit."""
    import torch.distributed as dist

    from acmil_tpu_torch.parallel import make_mesh, shard_params

    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)      # B6 for DSMIL
    conf = _conf(arch)
    torch.manual_seed(4)
    model, family = build_mil_model(conf)
    model.to(cuda_device)
    m_1, st_1, stats_1, _ = _epoch(conf, model, family, "graph", cuda_device)
    want = evaluate_scanned(make_scan_eval_step(m_1, family, route="graph"),
                            _loader(cuda_device, False), conf.n_class)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, cuda_device)
        assert mesh.backend == "nccl"
        shard_params(model, mesh)
        m_m, st_m, stats_m, scan = _epoch(conf, model, family, None,
                                          cuda_device, mesh)
        scan_eval = make_scan_eval_step(m_m, family, mesh=mesh,
                                        route=scan.route)
        got = evaluate_scanned(scan_eval, _loader(cuda_device, False, mesh),
                               conf.n_class, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert st_m.step == st_1.step > 0
    for (name, p), q in zip(m_m.named_parameters(), m_1.parameters()):
        assert torch.equal(p, q), name
    assert stats_m == stats_1
    _same_metrics(got, want)
    assert sum(scan.graphs.replays.values()) == st_m.step
    if arch == "dsmil":
        assert scan_eval.kernel_launches()["B6"] == len(_Source())
