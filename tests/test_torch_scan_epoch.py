"""The port's scanned epochs (acmil_tpu_torch: ``BagLoader.device_groups``,
``engine/train.py``'s scanned epochs, STKIM's branch and the learning rate on
the device, the Step3 CLI's ``--scan_epoch``) against the JAX package's
scanned epochs and against the port's own per-bag loop, on the fixtures of
``tests/test_scan_epoch.py``. On the CPU every scanned step runs eagerly;
the CUDA graph route is held against the eager one in
``tests/test_torch_gpu_scan_epoch.py``."""

import os

import jax
import jax.flatten_util  # not re-exported by the jax package root
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data.loader import BagLoader as JaxBagLoader
from acmil_tpu.engine.train import create_train_state as jax_create_state
from acmil_tpu.engine.train import make_scan_train_step as jax_make_scan
from acmil_tpu.engine.train import \
    train_one_epoch_scanned as jax_train_scanned
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import fast as jax_fast
from acmil_tpu_torch.cli import step3_acmil
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import BagLoader, write_feature_pt
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.engine.graphs import take
from acmil_tpu_torch.engine.schedules import half_cosine_schedule
from acmil_tpu_torch.engine.train import (DeviceSchedule, create_train_state,
                                          evaluate, evaluate_scanned,
                                          family_supports_scan,
                                          make_eval_step,
                                          make_scan_eval_step,
                                          make_scan_train_step,
                                          make_train_step, scan_route,
                                          train_one_epoch_scanned)
from acmil_tpu_torch.engine.families import FAMILIES
from acmil_tpu_torch.models import build_mil_model, fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import attn_pool, masked
from acmil_tpu_torch.parallel import Mesh
from tests.conftest import make_synthetic_bags
from tests.test_scan_epoch import _ListSource
from tests.test_torch_train import _stkim_case, _stkim_u

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_ARCHS = ("ga", "mha", "abmil", "clam_sb", "clam_mb", "dsmil")
# SAM ("+sam") and the other families; dtfd through B1/B2's plain versions
# (DTFD_FUSE_MIN_S pinned to 0)
LOOP_CASES = ("ga+sam", "dsmil+sam", "dtfd", "dtfd+sam", "pure", "mhim",
              "meanmil", "ilra", "bmil_spvis")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread at these tiny shapes: the lane's workers share
    the cores, and PyTorch's thread pools oversubscribed them (the TransMIL
    loop case took minutes there against a second alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _conf(arch="ga", **kw):
    """tests/test_scan_epoch.py's ``tiny_conf`` for the port."""
    d = dict(n_class=2, D_feat=32, D_inner=16, n_token=3, n_masked_patch=5,
             mask_drop=0.5, lr=1e-3, train_epoch=3, min_bucket=64, seed=0,
             arch=arch)
    d.update(kw)
    return Config.from_dict(d)


def _loaders(slides, shuffle=True, seed=0):
    src = _ListSource(slides)
    kw = dict(batch_size=1, min_bucket=64, seed=seed, shuffle=shuffle)
    return JaxBagLoader(src, **kw), BagLoader(src, **kw)


def _group_index(groups, stacked):
    return [g is stacked for g in groups].index(True)


# ---------------------------------------------------------------------------
# The stacked groups and the visit order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_device_groups_match_jax(synthetic_slides, shuffle):
    jl, pl = _loaders(synthetic_slides, shuffle)
    want, got = jl.device_groups(), pl.device_groups()
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for name in ("feats", "mask", "coords", "label"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)
    assert pl.device_groups() is got                 # built once
    # both consumed their rng alike: the later permutations agree
    np.testing.assert_array_equal(pl.rng.permutation(50),
                                  jl.rng.permutation(50))


@pytest.mark.parametrize("interleave", [1, 3])
def test_visit_order_matches_jax(synthetic_slides, interleave):
    jl, pl = _loaders(synthetic_slides)
    jgroups, pgroups = jl.device_groups(), pl.device_groups()
    jseq, pseq = [], []

    def jax_step(state, stacked, chunk, rng):
        jseq.append((_group_index(jgroups, stacked), tuple(np.asarray(chunk))))
        return state, {"loss": jnp.zeros(())}

    def port_step(state, stacked, chunk, groups):
        pseq.append((_group_index(pgroups, stacked),
                     tuple(int(i) for i in chunk)))
        return {"loss": torch.zeros(())}

    for epoch in range(3):
        jax_train_scanned(None, jax_step, jl, jax.random.PRNGKey(0), epoch,
                          interleave=interleave)
        train_one_epoch_scanned(None, port_step, pl, epoch,
                                interleave=interleave)
    assert pseq == jseq
    n_bags = sum(int(g.label.shape[0]) for g in pgroups)
    assert sum(len(c) for _, c in pseq) == 3 * n_bags
    if interleave > 1:
        assert len(pseq) > 3 * len(pgroups)


# ---------------------------------------------------------------------------
# The scanned step against the port's per-bag loop and against JAX
# ---------------------------------------------------------------------------

def _twin_states(conf, n_steps):
    torch.manual_seed(3)
    model, family = build_mil_model(conf)
    twin, _ = build_mil_model(conf)
    twin.load_state_dict(model.state_dict())
    return ((model, create_train_state(model, conf, n_steps, family=family)),
            (twin, create_train_state(twin, conf, n_steps, family=family)),
            family)


@pytest.mark.parametrize("arch", GRAPH_ARCHS + ("transmil",) + LOOP_CASES)
def test_scanned_epoch_equals_the_loop_in_its_order(synthetic_slides, arch,
                                                    monkeypatch):
    """Bit for bit: the same bags in the same order make the same draws
    (STKIM's from the state's generator, dropout from torch's, SAM's second
    pass the first's), and STKIM's branch on the device keeps the host
    branch's numbers; MHIM's teacher too."""
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)     # CLAM and DSMIL fused
    monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", 0)
    arch, _, opt = arch.partition("+")
    # ACMIL_GA, CLAM and DTFD take the kernels' route only without dropout
    fused = arch in ("ga", "dtfd") or arch.startswith("clam")
    conf = _conf(arch, droprate=0.0 if fused else 0.25, use_sam=opt == "sam",
                 dropout=0.25, mlp_dim=16, mask_ratio=0.1, mask_ratio_h=0.2,
                 mask_ratio_hr=0.5, mm=0.9, mm_sche=True, mrh_sche=True,
                 steps_per_epoch=20)
    branches = []
    real = fast._stkim_correct
    monkeypatch.setattr(fast, "_stkim_correct", lambda *a, **k: branches.append(
        k.get("on_device", a[-1] if len(a) > 10 else False)) or real(*a, **k))
    _, loader = _loaders(synthetic_slides)
    groups = loader.device_groups()
    n = sum(int(g.label.shape[0]) for g in groups)
    (m_s, st_s), (m_l, st_l), family = _twin_states(conf, n)
    torch.manual_seed(11)
    scan = make_scan_train_step(m_s, conf, family)
    assert scan.route == "eager" and "cpu" in scan.reason
    seen = []

    def recording(state, stacked, chunk, groups):
        seen.append((stacked, [int(i) for i in chunk]))
        return scan(state, stacked, chunk, groups)

    _, stats = train_one_epoch_scanned(st_s, recording, loader, 0,
                                       interleave=2)
    torch.manual_seed(11)
    step = make_train_step(m_l, conf, family)
    totals = {}
    for stacked, chunk in seen:
        for i in chunk:
            aux = step(st_l, take(stacked, torch.tensor([i])))
            for k, v in aux.items():
                totals[k] = totals[k] + v if k in totals else v.clone()
    assert st_s.step == st_l.step == n
    # ACMIL_GA's STKIM: the scanned steps on the device, the loop's on the
    # host, in each of SAM's two passes
    passes = 2 if conf.use_sam else 1
    assert branches == ([True] * passes * n + [False] * passes * n
                        if arch == "ga" else [])
    for (name, p), q in zip(m_s.named_parameters(), m_l.parameters()):
        assert torch.equal(p, q), name
    if st_s.teacher is not None:
        for (name, p), q in zip(st_s.teacher.named_parameters(),
                                st_l.teacher.parameters()):
            assert torch.equal(p, q), "teacher " + name
    # sums per dispatch, then over dispatches: another order of float adds
    assert stats.keys() == totals.keys()
    for k, v in totals.items():
        np.testing.assert_allclose(stats[k], float(v) / n, rtol=1e-6)
    assert np.isfinite(stats["loss"])


@pytest.mark.parametrize("arch", ["abmil", "ga", "ga+sam"])
def test_scanned_epoch_matches_jax(synthetic_slides, arch, monkeypatch):
    """One scanned epoch against JAX's, STKIM on with the JAX side's draws
    (both SAM passes take the step's), SAM in the body with ``+sam``: the
    epoch's mean loss to 1e-4 and mean gradient norm to 1e-3 relative, and
    the parameters to lr per step absolute (the bounds of
    tests/test_torch_train.py::test_five_adamw_steps_match_jax)."""
    arch, _, opt = arch.partition("+")
    sam = dict(use_sam=True, sam_rho=0.05) if opt == "sam" else {}
    jconf = JaxConfig.from_dict(dict(
        n_class=2, D_feat=32, D_inner=16, n_token=3, n_masked_patch=5,
        mask_drop=0.5, lr=1e-3, train_epoch=3, min_bucket=64, seed=0,
        arch=arch, **sam))
    conf = _conf(arch, **sam)
    jl, pl = _loaders(synthetic_slides)
    rng = jax.random.PRNGKey(7)
    jm, jfam = jax_build_model(jconf)
    n = len(pl)
    example = jax.tree_util.tree_map(lambda t: t[0], jl.device_groups()[0])
    jstate = jax_create_state(jm, jconf, jax.random.PRNGKey(0), example, n,
                              family=jfam)
    model, family = build_mil_model(conf)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), arch))
    jstate, jstats = jax_train_scanned(
        jstate, jax_make_scan(jm, jconf, jfam), jl, rng, 0)
    state = create_train_state(model, conf, n, family=family)

    def jax_draws(shape, generator, device, **kw):
        s_rng, _ = jax.random.split(jax.random.fold_in(rng, state.step))
        return _stkim_u(jax_fast.derive_stkim_rng(s_rng), tuple(shape))

    monkeypatch.setattr(masked, "draw", jax_draws)
    _, stats = train_one_epoch_scanned(
        state, make_scan_train_step(model, conf, family), pl, 0)
    assert state.step == int(jstate.step) == n
    np.testing.assert_allclose(stats["loss"], jstats["loss"], rtol=1e-4)
    np.testing.assert_allclose(stats["grad_norm"], jstats["grad_norm"],
                               rtol=1e-3)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                           arch)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=n * conf.lr, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", ["ga", "abmil", "clam_mb", "dsmil"])
def test_evaluate_scanned_equals_evaluate(synthetic_slides, arch,
                                          monkeypatch):
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)     # CLAM and DSMIL fused
    conf = _conf(arch)
    torch.manual_seed(5)
    model, family = build_mil_model(conf)
    _, loader = _loaders(synthetic_slides, shuffle=False)
    _, scan_loader = _loaders(synthetic_slides, shuffle=False)
    want = evaluate(make_eval_step(model, family), loader, conf.n_class)
    scan_eval = make_scan_eval_step(model, family)
    got = evaluate_scanned(scan_eval, scan_loader, conf.n_class)
    _same_metrics(got, want)


# ---------------------------------------------------------------------------
# What the graph needs in the step: STKIM's branch and the rate on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extreme", [False, True])
def test_stkim_device_branch_equals_the_host_branch(extreme):
    """The extreme case leaves under 1e-5 of the mass kept, so the host
    takes the exact recompute; the other keeps the O(K·k) subtraction.
    Outputs and gradients agree bit for bit."""
    feats, mask, ws, nm, md, key = _stkim_case(extreme)
    feats, mask = torch.from_numpy(feats), torch.from_numpy(mask)
    u, outs = None, []
    for on_device in (False, True):
        w = [torch.from_numpy(x).requires_grad_() for x in ws]
        bag, logits = attn_pool.gated_attn_pool_grad(feats, mask, *w)
        if u is None:
            u = _stkim_u(key, tuple(logits.shape))
            drop, idx = masked.stkim_drop(logits.detach(), nm, md,
                                          mask[:, None, :], u)
            lse = torch.logsumexp(torch.where(mask[:, None, :], logits,
                                              masked.NEG_INF), -1, True)
            p = torch.exp(torch.gather(logits, -1, idx) - lse) * \
                torch.gather(drop, -1, idx)
            # the case takes the branch it is meant to
            kept = float((1 - p.sum(-1)).min().detach())
            assert (kept < fast._STKIM_KEPT_MIN) == extreme
        got, a = fast._stkim_correct(bag, logits, feats, mask, w[0], nm, md,
                                     u=u, on_device=on_device)
        (got.square().sum() + a.clamp_min(-1e3).sum()).backward()
        outs.append((got, a, *(t.grad for t in w)))
    for i, (h, d) in enumerate(zip(*outs)):
        assert torch.equal(h, d), i


@pytest.mark.parametrize("warmup", [0, 2])
def test_device_rate_equals_half_cosine_schedule(warmup):
    """Every step of an epoch, in two dispatches: the table holds the
    schedule rounded to float32."""
    per_epoch = 17
    sched = half_cosine_schedule(1e-4, 1e-6, 5, warmup, per_epoch)
    ds = DeviceSchedule(sched, per_epoch, torch.device("cpu"))
    for epoch in range(3):
        got, start = [], epoch * per_epoch
        for lo, hi in ((0, 9), (9, per_epoch)):
            ds.load(start + lo, hi - lo)
            for _ in range(hi - lo):
                ds.advance()
                got.append(float(ds.lr))
        want = [float(np.float32(sched(start + j))) for j in range(per_epoch)]
        assert got == want
        np.testing.assert_allclose(got, [sched(start + j) for j in
                                         range(per_epoch)], rtol=1e-7)


def test_routes_and_families():
    assert all(family_supports_scan(f) for f in FAMILIES.values())
    for arch in GRAPH_ARCHS + ("dtfd", "pure", "mhim", "transmil", "ilra",
                               "bmil_spvis"):
        route, why = scan_route(_conf(arch), torch.device("cuda"))
        assert route == "graph", why
        assert scan_route(_conf(arch), "cpu")[0] == "eager"
    for arch in GRAPH_ARCHS + ("dtfd", "transmil", "meanmil"):
        route, why = scan_route(_conf(arch, use_sam=True),
                                torch.device("cuda"))
        assert route == "graph" and "with SAM" in why, why
    route, why = scan_route(_conf("nope"), torch.device("cuda"))
    assert route == "eager" and "registry" in why
    # a mesh scan step builds, on the mesh's eager route on the CPU
    mesh = Mesh(1, 1, 0, torch.device("cpu"))
    scan = make_scan_train_step(build_mil_model(_conf())[0], _conf(),
                                "acmil", mesh=mesh)
    assert scan.route == "eager" and "cpu" in scan.reason
    assert make_scan_eval_step(build_mil_model(_conf())[0], "acmil",
                               mesh=mesh).route == "eager"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    slides = make_synthetic_bags(n_slides=14, d=32, seed=3, min_len=40,
                                 max_len=250)
    write_feature_pt(str(d / "patch_feats_pretrain_tiny.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    import json
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:9], "val_names": names[9:11],
                   "test_names": names[11:]}, f)
    with open(d / "tiny.yml", "w") as f:
        yaml.safe_dump(dict(dataset="camelyon", n_class=2, pretrain="tiny",
                            D_feat=32, D_inner=16, n_token=3,
                            n_masked_patch=5, mask_drop=0.5, train_epoch=2,
                            min_bucket=64, scan_interleave=2,
                            split_dir=str(d / "splits")), f)
    return d


def test_step3_scan_epoch_on_the_cpu(corpus, capsys):
    d = corpus
    argv = ["--config", str(d / "tiny.yml"), "--data_dir", str(d),
            "--seed", "0", "--ckpt_dir", str(d / "ckpt"),
            "--log_dir", str(d / "log"), "--device", "cpu", "--scan_epoch"]
    best = step3_acmil.main(argv)
    out = capsys.readouterr().out
    assert out.count("scan_epoch: eager route") == 1
    assert 0.0 <= best["acc"] <= 1.0 and np.isfinite(best["loss"])
    last = checkpoint.load(checkpoint.checkpoint_path(str(d / "ckpt"), "last"))
    assert last["epoch"] == 1 and last["step"] == 2 * 9
    assert {int(s["step"]) for s in last["optimizer"]["state"].values()} == {
        18}
    evald = step3_acmil.main(argv + ["--eval_only"])
    best_ck = checkpoint.load(checkpoint.checkpoint_path(str(d / "ckpt"),
                                                         "best"))
    for k in ("acc", "auc", "f1", "loss"):
        assert evald[k] == pytest.approx(best_ck["metrics"][k], nan_ok=True)


def test_step3_scan_epoch_on_a_mesh_is_refused(corpus):
    """What a scanned epoch on a mesh still refuses: a B that does not split
    over the data axis (JAX's tests/test_scan_epoch.py::
    test_device_groups_mesh_batch_divisibility). ``--scan_epoch`` with
    ``--mesh_data 2`` gets past every option check to the mesh's layout,
    which one process cannot hold (the two-rank run:
    tests/test_torch_scan_mesh.py)."""
    with pytest.raises(ValueError, match="divisible by the data axis"):
        BagLoader(_ListSource(make_synthetic_bags(4)), 3,
                  mesh=Mesh(2, 1, 0, torch.device("cpu"))).device_groups()
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        step3_acmil.main(["--config", str(corpus / "tiny.yml"),
                          "--data_dir", str(corpus), "--device", "cpu",
                          "--scan_epoch", "--mesh_data", "2"])
