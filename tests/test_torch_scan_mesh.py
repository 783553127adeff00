"""Scanned epochs on a ``(data, seq)`` mesh (acmil_tpu_torch:
``BagLoader.device_groups`` on a mesh, the scanned step and eval on a mesh,
``scan_route``'s mesh reasons, STKIM's branch on the device across ranks,
and ``cli/train.py``'s cache gate) on the CPU with ``gloo``.

Ranks are spawned with ``tests/torch_ranks.py``, one module-scoped group per
world size, each running all its cases once. Held:

- (i) one scanned epoch of ACMIL_GA with STKIM at data 2 x seq 2 against
  the JAX package's scanned epoch on its (data 2, seq 2) mesh of virtual CPU
  devices, with the JAX side's uniforms: the epoch's mean loss to 1e-4 and
  mean gradient norm to 1e-3 relative, the parameters to lr per step
  absolute (the bounds of tests/test_torch_scan_epoch.py);
- (ii) ABMIL and DSMIL at data 2: the scanned epoch against the per-bag
  mesh loop in the same order and the scanned eval against ``evaluate`` on
  the mesh, equal but for the order of float sums (1e-6);
- (iii) each rank's stacked groups against ``shard_bag`` of the one-process
  groups; (iv) ``scan_route`` with a mesh; (v) STKIM's device branch against
  the host branch at data 2 x seq 2, on both sides of ``_STKIM_KEPT_MIN``,
  bit for bit; (vi) ``step3_acmil.main --scan_epoch --mesh_data 2`` at B 2
  on two ranks, the cache gate taken, against one process that caches and
  scans the same batches (the tolerances of tests/test_torch_parallel.py).

Ranks import this module: JAX is imported inside the functions that need
it, never at module level.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_ranks import ranks, spawn

TINY = dict(n_class=2, D_feat=32, D_inner=16, n_token=3, n_masked_patch=5,
            mask_drop=0.5, lr=1e-3, train_epoch=3, min_bucket=64, seed=0)
# the cohort of the engine cases: lengths over the 64, 128 and 256 buckets
COHORT = dict(n_slides=12, d=32, seed=7, min_len=40, max_len=200)
B = 2
# (ii): the scanned and the per-bag routes add the same floats in another
# order only in the epoch's sums and the eval loss's mean
SAME_RTOL = 1e-6


class _Src:
    """In-RAM bags with the loader's source protocol."""

    def __init__(self, slides):
        self.items = [{"input": d["feat"], "coords": d["coords"],
                       "label": d["label"]} for d in slides.values()]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it["input"]) for it in self.items]


def _conf(arch, **kw):
    from acmil_tpu_torch.config import Config

    return Config.from_dict(dict(TINY, arch=arch, **kw))


def _loader(slides, mesh, shuffle=True, batch=B):
    from acmil_tpu_torch.data import BagLoader

    return BagLoader(_Src(slides), batch, shuffle=shuffle, seed=0,
                     min_bucket=64, prefetch=0, mesh=mesh)


def _np(t):
    return t.detach().cpu().numpy()


def _params(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _case_ga_scan(inp):
    """(i): one scanned epoch of ACMIL_GA with STKIM at data 2 x seq 2, from
    the JAX state's weights, with the JAX steps' uniforms."""
    from acmil_tpu_torch.engine import (create_train_state,
                                        make_scan_train_step,
                                        train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.ops import masked
    from acmil_tpu_torch.parallel import make_mesh, shard_params
    from acmil_tpu_torch.parallel.mesh import global_rows

    mesh = make_mesh(2, 2)
    conf = _conf("ga")
    model, fam = build_mil_model(conf, mesh=mesh)
    model.load_state_dict(inp["ga_weights"])
    shard_params(model, mesh)
    loader = _loader(inp["slides"], mesh)
    state = create_train_state(model, conf, len(loader), family=fam)
    table = inp["ga_u"]

    def jax_draws(shape, generator, device, **kw):
        # the global batch's uniforms of this step, this rank's rows
        return global_rows(lambda s: torch.from_numpy(
            table[(state.step, s[-1])]), shape)

    scan = make_scan_train_step(model, conf, fam, mesh=mesh)
    real = masked.draw
    masked.draw = jax_draws
    try:
        _, stats = train_one_epoch_scanned(state, scan, loader, 0)
    finally:
        masked.draw = real
    return {"stats": stats, "step": state.step, "params": _params(model),
            "route": (scan.route, scan.reason)}


def _stkim_inputs(extreme):
    """A batch of two bags on either side of ``_STKIM_KEPT_MIN``: peaked
    logits, or a logit gap wide enough that dropping the top-k leaves under
    1e-5 of the mass (the cases of tests/test_torch_train.py, two bags)."""
    if extreme:
        rs, (b, n, df, l, a, k) = np.random.RandomState(11), (2, 256, 16, 8, 8, 3)
        scales, nm, md = (0.3, 0.0, 1.0, 0.1, 1.0, 0.1, 40.0, 0.1), 4, 1.0
        mask = rs.rand(b, n) < 0.9
    else:
        rs, (b, n, df, l, a, k) = np.random.RandomState(5), (2, 512, 32, 16, 16, 4)
        scales, nm, md = (0.3, 0.0, 0.5, 0.1, 0.5, 0.1, 3.0, 0.1), 8, 0.5
        mask = rs.rand(b, n) < 0.8
    feats = rs.randn(b, n, df).astype(np.float32)
    shapes = [(df, l), (l,), (l, a), (a,), (l, a), (a,), (a, k), (k,)]
    ws = [(rs.randn(*s) * sc).astype(np.float32) for s, sc in zip(shapes,
                                                                  scales)]
    u = rs.rand(b, k, n).astype(np.float32)
    return feats, mask, ws, nm, md, u


def _stkim_run(feats, mask, ws, nm, md, u, mesh, on_device):
    """STKIM's correction of the sequence-sharded pooling on this rank's
    part; its outputs and the weights' gradients of a loss of both."""
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops import attn_pool
    from acmil_tpu_torch.parallel import collectives as C

    w = [torch.from_numpy(x).requires_grad_() for x in ws]
    group = mesh.seq_group if mesh is not None else None
    if group is None:
        bag, logits = attn_pool.gated_attn_pool_grad(feats, mask, *w)
        whole = mask
    else:
        bag, logits = attn_pool.sharded_gated_attn_pool_grad(feats, mask, *w,
                                                             group)
        logits = C.all_gather(logits, group, dim=2)
        whole = torch.cat(C.gather_list(mask, group), dim=1)
    got, a = fast._stkim_correct(bag, logits, feats, whole, w[0], nm, md,
                                 u=u, mesh=mesh, on_device=on_device)
    (got.square().sum() + a.clamp_min(-1e3).sum()).backward()
    grads = [t.grad.clone() for t in w]
    if mesh is not None:
        for g in grads:
            C.all_reduce_(g, mesh.world_group)
    return [_np(got), _np(a)] + [_np(g) for g in grads]


def _case_stkim(inp):
    """(v): the host branch and the device branch of STKIM's correction at
    data 2 x seq 2, on both sides of the threshold."""
    from acmil_tpu_torch.parallel import make_mesh
    from acmil_tpu_torch.parallel.mesh import active, shard_bag

    mesh = make_mesh(2, 2)
    out = {}
    for extreme in (False, True):
        feats, mask, ws, nm, md, u = _stkim_inputs(extreme)
        b, n = mask.shape
        part = shard_bag(_bag(feats, mask, np.zeros((b, n, 2), np.int32),
                              np.zeros(b)), mesh, shard_seq=True)
        rows = b // mesh.data
        u_mine = torch.from_numpy(u[mesh.data_index * rows:][:rows])
        with active(mesh):
            out[extreme] = [_stkim_run(part.feats, part.mask, ws, nm, md,
                                       u_mine, mesh, on_device)
                            for on_device in (False, True)]
    return out


def _bag(feats, mask, coords, labels):
    from acmil_tpu_torch.data.bags import Bag

    return Bag(torch.from_numpy(np.ascontiguousarray(feats)),
               torch.from_numpy(np.ascontiguousarray(mask)),
               torch.from_numpy(np.ascontiguousarray(coords)),
               torch.from_numpy(np.asarray(labels, np.int64)))


def _case_heads(inp):
    """(ii): ABMIL and DSMIL at data 2, the scanned epoch against the
    per-bag mesh loop in the scanned visit order, and the scanned eval
    (DSMIL's through B6's route) against ``evaluate``."""
    from acmil_tpu_torch.engine import (create_train_state, evaluate,
                                        evaluate_scanned, make_eval_step,
                                        make_scan_eval_step,
                                        make_scan_train_step,
                                        make_train_step,
                                        train_one_epoch_scanned)
    from acmil_tpu_torch.engine.graphs import take
    from acmil_tpu_torch.models import build_mil_model, fast
    from acmil_tpu_torch.parallel import make_mesh, shard_params

    mesh = make_mesh(2, 1)
    fast.FUSE_MIN_N = 0                  # DSMIL's eval through B6's route
    slides = inp["slides"]
    out = {}
    for arch in ("abmil", "dsmil"):
        conf = _conf(arch, droprate=0.25)
        torch.manual_seed(3)
        m_s, fam = build_mil_model(conf, mesh=mesh)
        m_l, _ = build_mil_model(conf, mesh=mesh)
        m_l.load_state_dict(m_s.state_dict())
        shard_params(m_s, mesh)
        shard_params(m_l, mesh)
        loader = _loader(slides, mesh)
        st_s = create_train_state(m_s, conf, len(loader), family=fam)
        st_l = create_train_state(m_l, conf, len(loader), family=fam)
        scan = make_scan_train_step(m_s, conf, fam, mesh=mesh)
        seen = []

        def recording(state, stacked, chunk, groups):
            seen.append((stacked, [int(i) for i in chunk]))
            return scan(state, stacked, chunk, groups)

        torch.manual_seed(11)
        _, stats = train_one_epoch_scanned(st_s, recording, loader, 0)
        torch.manual_seed(11)
        step = make_train_step(m_l, conf, fam, mesh=mesh)
        totals, n = {}, 0
        for stacked, chunk in seen:
            for i in chunk:
                aux = step(st_l, take(stacked, torch.tensor([i])))
                n += 1
                for k, v in aux.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
        scan_eval = make_scan_eval_step(m_s, fam, mesh=mesh)
        got = evaluate_scanned(scan_eval, _loader(slides, mesh, False),
                               conf.n_class, mesh=mesh)
        want = evaluate(make_eval_step(m_s, fam, mesh=mesh),
                        _loader(slides, mesh, False), conf.n_class,
                        mesh=mesh)
        out[arch] = {"steps": (st_s.step, st_l.step, n),
                     "route": (scan.route, scan.reason),
                     "stats": stats,
                     "loop": {k: v / n for k, v in totals.items()},
                     "scan_params": _params(m_s),
                     "loop_params": _params(m_l),
                     "eval": (got, want)}
    return out


def _cli_argv(inp, tag, *extra):
    return ["--config", inp["cli_yaml"], "--data_dir", inp["cli_dir"],
            "--ckpt_dir", os.path.join(inp["cli_out"], tag, "ckpt"),
            "--log_dir", os.path.join(inp["cli_out"], tag, "log"),
            "--device", "cpu", "--seed", "0", "--scan_epoch", *extra]


def _case_cli(inp):
    """(vi): step3_acmil.main --scan_epoch --mesh_data 2 at B 2."""
    from acmil_tpu_torch.cli import step3_acmil

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        best = step3_acmil.main(_cli_argv(inp, "mesh", "--mesh_data", "2"))
    return {"best": best, "lines": [ln for ln in text.getvalue().splitlines()
                                    if ln.startswith("scan_epoch")]}


CASES = {"ga_scan": _case_ga_scan, "stkim": _case_stkim,
         "heads": _case_heads, "cli": _case_cli}


def _ranks(group, name):
    return ranks(group, CASES[name])


# ---------------------------------------------------------------------------
# the JAX side and the groups of ranks
# ---------------------------------------------------------------------------

def _cohort():
    from tests.conftest import make_synthetic_bags

    return make_synthetic_bags(**COHORT)


def _jax_ga_scan(slides):
    """The JAX scanned epoch of ACMIL_GA at (data 2, seq 2): its initial
    weights for the port, the uniforms of every step at every bucket, and
    its state and stats after the epoch."""
    import jax
    import jax.numpy as jnp

    from acmil_tpu.config import Config as JaxConfig
    from acmil_tpu.data.loader import BagLoader as JaxBagLoader
    from acmil_tpu.engine.train import (create_train_state,
                                        make_scan_train_step,
                                        train_one_epoch_scanned)
    from acmil_tpu.models import build_mil_model
    from acmil_tpu.models import fast as jax_fast
    from acmil_tpu.parallel import make_mesh, shard_params
    from acmil_tpu_torch.models.convert import from_jax_params

    conf = JaxConfig(**TINY, arch="ga")
    model, fam = build_mil_model(conf)
    mesh = make_mesh(data=2, seq=2)
    loader = JaxBagLoader(_Src(slides), batch_size=B, min_bucket=64, seed=0,
                          shuffle=True, mesh=mesh)
    example = next(iter(JaxBagLoader(_Src(slides), batch_size=B,
                                     min_bucket=64)))
    n = len(loader)
    state = create_train_state(model, conf, jax.random.PRNGKey(0), example,
                               n, family=fam)
    weights = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                     state.params), "ga")
    rng = jax.random.PRNGKey(7)
    with mesh:
        state = shard_params(state, mesh)
        state, stats = train_one_epoch_scanned(
            state, make_scan_train_step(model, conf, fam, mesh=mesh), loader,
            rng, 0)
        buckets = {int(g.feats.shape[2]) for g in loader.device_groups()}
    table = {}
    for step in range(n):
        s_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
        key = jax_fast.derive_stkim_rng(s_rng)
        for m in buckets:
            table[(step, m)] = np.array(jax.random.uniform(
                key, (B, conf.n_token, m), dtype=jnp.float32))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                    state.params), "ga")
    return weights, table, int(state.step), stats, params, sorted(buckets)


def _write_cli_corpus(d):
    """A small torch feature file with a frozen split; a YAML at B 2, and
    the same YAML with ``cache_train: true`` for the one-process run."""
    import yaml

    from acmil_tpu_torch.data import write_feature_pt
    from tests.conftest import make_synthetic_bags

    slides = make_synthetic_bags(n_slides=14, d=32, seed=3, min_len=40,
                                 max_len=250)
    write_feature_pt(os.path.join(d, "patch_feats_pretrain_tiny.pt"), slides)
    names = sorted(slides)
    os.makedirs(os.path.join(d, "splits", "camelyon"))
    with open(os.path.join(d, "splits", "camelyon", "split_0.json"), "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:11],
                   "test_names": names[11:]}, f)
    base = dict(dataset="camelyon", n_class=2, pretrain="tiny", D_feat=32,
                D_inner=16, arch="ga", n_token=3, n_masked_patch=5,
                mask_drop=0.5, lr=1e-3, train_epoch=2, min_bucket=64, B=B,
                split_dir=os.path.join(d, "splits"))
    paths = []
    for name, extra in (("mesh.yml", {}), ("one.yml", {"cache_train": True})):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(dict(base, **extra), f)
    return paths


@pytest.fixture(scope="module")
def jax_ga():
    slides = _cohort()
    return slides, _jax_ga_scan(slides)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_ga):
    """Cases (i) and (v) on four ranks, data 2 x seq 2."""
    slides, (weights, table, *_) = jax_ga
    tmp = str(tmp_path_factory.mktemp("world4"))
    inputs = {"slides": slides, "ga_weights": weights, "ga_u": table}
    return spawn(4, [CASES["ga_scan"], CASES["stkim"]], inputs,
                 os.path.join(tmp, "ranks"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Cases (ii) and (vi) on two ranks, data 2."""
    tmp = str(tmp_path_factory.mktemp("world2"))
    cli_dir = os.path.join(tmp, "corpus")
    os.makedirs(cli_dir)
    yml, one = _write_cli_corpus(cli_dir)
    inputs = {"slides": _cohort(), "cli_yaml": yml, "cli_one": one,
              "cli_dir": cli_dir, "cli_out": os.path.join(tmp, "runs")}
    group = spawn(2, [CASES["heads"], CASES["cli"]], inputs,
                  os.path.join(tmp, "ranks"))
    group["inputs"] = inputs
    return group


# ---------------------------------------------------------------------------
# (i) ACMIL_GA at data 2 x seq 2 against JAX's scanned mesh epoch
# ---------------------------------------------------------------------------

def test_acmil_ga_scanned_mesh_epoch_matches_jax(world4, jax_ga):
    _, (_, _, n, jstats, want, buckets) = jax_ga
    assert len(buckets) > 1                  # more than one stacked group
    got_ranks = _ranks(world4, "ga_scan")
    for got in got_ranks:
        assert got["step"] == n
        assert got["route"][0] == "eager" and "cpu" in got["route"][1]
        np.testing.assert_allclose(got["stats"]["loss"], jstats["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["stats"]["grad_norm"],
                                   jstats["grad_norm"], rtol=1e-3)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want[name].numpy(),
                                       atol=n * TINY["lr"], rtol=0,
                                       err_msg=name)
    # every rank holds the same parameters and the same sums
    for got in got_ranks[1:]:
        assert got["stats"] == got_ranks[0]["stats"]
        for name, p in got["params"].items():
            np.testing.assert_array_equal(p, got_ranks[0]["params"][name])


# ---------------------------------------------------------------------------
# (ii) ABMIL and DSMIL at data 2 against the per-bag mesh loop
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("arch", ["abmil", "dsmil"])
def test_scanned_mesh_epoch_and_eval_equal_the_loop(world2, arch):
    outs = [r[arch] for r in _ranks(world2, "heads")]
    for got in outs:
        s, l, n = got["steps"]
        assert s == l == n > 0
        assert got["route"][0] == "eager"
        for name, p in got["scan_params"].items():
            np.testing.assert_allclose(p, got["loop_params"][name],
                                       rtol=0, atol=1e-6, err_msg=name)
        assert got["stats"].keys() == got["loop"].keys()
        for k, v in got["loop"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=SAME_RTOL,
                                       err_msg=k)
        _same_metrics(*got["eval"])
    # every rank computes the same metrics and holds the same parameters
    for got in outs[1:]:
        assert got["eval"][0] == outs[0]["eval"][0]
        for name, p in got["scan_params"].items():
            np.testing.assert_array_equal(p, outs[0]["scan_params"][name])


# ---------------------------------------------------------------------------
# (iii) the stacked groups each rank holds
# ---------------------------------------------------------------------------

def _fake_mesh(data, seq, rank):
    from acmil_tpu_torch.parallel import Mesh

    return Mesh(data, seq, rank, torch.device("cpu"))


@pytest.mark.parametrize("data,seq", [(2, 1), (2, 2), (1, 2)])
def test_device_groups_per_rank_are_shard_bag_of_one_process(data, seq):
    from acmil_tpu_torch.engine.graphs import take
    from acmil_tpu_torch.parallel import shard_bag

    slides = _cohort()
    # one process: the same plan, ragged batches padded as on a mesh
    one = _loader(slides, _fake_mesh(1, 1, 0), batch=4)
    whole = one.device_groups()
    assert len(whole) > 1
    later = one.rng.permutation(50)
    for r in range(data * seq):
        mesh = _fake_mesh(data, seq, r)
        loader = _loader(slides, mesh, batch=4)
        groups = loader.device_groups()
        assert len(groups) == len(whole)
        for g, w in zip(groups, whole):
            k = int(w.label.shape[0])
            assert int(g.label.shape[0]) == k
            # the global shape of the group, and this rank's part of it
            assert g.feats.shape[1] * data == w.feats.shape[1]
            assert g.feats.shape[2] * seq == w.feats.shape[2]
            for i in range(k):
                idx = torch.tensor([i])
                want = shard_bag(take(w, idx), mesh, shard_seq=seq > 1)
                got = take(g, idx)
                for name in ("feats", "mask", "coords", "label"):
                    np.testing.assert_array_equal(
                        getattr(got, name).numpy(),
                        getattr(want, name).numpy(), err_msg=name)
        # the later permutations agree across ranks
        np.testing.assert_array_equal(loader.rng.permutation(50), later)


# ---------------------------------------------------------------------------
# (iv) the route of a scanned step on a mesh
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("ga", "mha", "abmil", "clam_sb", "clam_mb", "dsmil")


def _mesh(data, seq, backend):
    from acmil_tpu_torch.parallel import Mesh

    return Mesh(data, seq, 0, torch.device("cuda"), backend=backend)


@pytest.mark.parametrize("arch", GRAPH_ARCHS + ("transmil",))
def test_scan_route_on_a_mesh(arch):
    from acmil_tpu_torch.engine.train import scan_route

    conf, cuda = _conf(arch), torch.device("cuda")
    one = scan_route(conf, cuda)
    # a world of one takes the one process's route, on either backend
    for backend in ("nccl", "gloo"):
        assert scan_route(conf, cuda, _mesh(1, 1, backend)) == one
    # every arch of the registry graphs in one process
    assert one[0] == "graph"
    route, why = scan_route(conf, cuda, _mesh(2, 1, "gloo"))
    assert route == "eager" and "gloo collectives stage through the host" \
        in why and "cannot be captured" in why
    for data, seq in ((2, 1), (2, 2), (1, 4)):
        route, why = scan_route(conf, cuda, _mesh(data, seq, "nccl"))
        assert route == "eager" and "NCCL capture across cards has not " \
            "been checked on a card" in why
    # the CPU's reason comes first
    route, why = scan_route(conf, "cpu", _mesh(2, 1, "gloo"))
    assert route == "eager" and "cpu" in why


def test_graph_route_is_refused_across_processes():
    from acmil_tpu_torch.engine.train import ScanTrainStep, make_scan_eval_step
    from acmil_tpu_torch.models import build_mil_model

    conf = _conf("abmil")
    model, fam = build_mil_model(conf)
    with pytest.raises(ValueError, match="needs a card"):
        ScanTrainStep(model, conf, fam, "graph", _fake_mesh(2, 1, 0))
    with pytest.raises(ValueError, match="mesh of one process only"):
        make_scan_eval_step(model, fam, mesh=_fake_mesh(2, 1, 0),
                            route="graph")


# ---------------------------------------------------------------------------
# (v) STKIM's branch on the device across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extreme", [False, True])
def test_stkim_device_branch_on_a_mesh_equals_the_host_branch(world4,
                                                              extreme):
    """Outputs and the world's gradients, bit for bit, on every rank; the
    case lies on the side of the threshold it is meant to, and the ranks'
    gradients are one process's."""
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops import masked

    feats, mask, ws, nm, md, u = _stkim_inputs(extreme)
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        from acmil_tpu_torch.ops import attn_pool

        _, logits = attn_pool.gated_attn_pool_grad(
            t(feats), t(mask), *[t(w) for w in ws])
        drop, idx = masked.stkim_drop(logits, nm, md, t(mask)[:, None, :],
                                      t(u))
        lse = torch.logsumexp(torch.where(t(mask)[:, None, :], logits,
                                          masked.NEG_INF), -1, True)
        p = torch.exp(torch.gather(logits, -1, idx) - lse) * \
            torch.gather(drop, -1, idx)
        kept = float((1 - p.sum(-1)).min())
    assert (kept < fast._STKIM_KEPT_MIN) == extreme
    one = _stkim_run(t(feats), t(mask), ws, nm, md, t(u), None, True)
    for r, res in enumerate(_ranks(world4, "stkim")):
        host, device = res[extreme]
        for i, (h, d) in enumerate(zip(host, device)):
            np.testing.assert_array_equal(h, d, err_msg=f"rank {r} out {i}")
        # the weights' gradients summed over the world: twice one
        # process's (each seq rank holds its data rows' whole gradient), to
        # 1e-5 of the largest (the exact branch's reach 1e4)
        for i, (g, w) in enumerate(zip(device[2:], one[2:])):
            np.testing.assert_allclose(g, 2 * w, rtol=0,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=f"rank {r} grad {i}")


# ---------------------------------------------------------------------------
# (vi) the CLI at --mesh_data 2, B 2, the cache gate taken
# ---------------------------------------------------------------------------

def test_step3_scan_epoch_on_two_ranks_matches_one_process(world2, tmp_path):
    from acmil_tpu_torch.cli import step3_acmil

    inp = world2["inputs"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        want = step3_acmil.main(_cli_argv(
            dict(inp, cli_yaml=inp["cli_one"], cli_out=str(tmp_path)),
            "one"))
    assert any(ln.startswith("scan_epoch: eager route")
               for ln in text.getvalue().splitlines())
    outs = _ranks(world2, "cli")
    # rank 0 alone prints the route once: the gate cached the train bags
    assert outs[0]["lines"] == [ln for ln in outs[0]["lines"]
                                if "eager route" in ln] and \
        len(outs[0]["lines"]) == 1, outs[0]["lines"]
    assert outs[1]["lines"] == []
    for got in outs:
        assert got["best"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got["best"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
