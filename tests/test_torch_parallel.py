"""Step3 across processes (acmil_tpu_torch/parallel, the sharded pooling and
Nystrom, the mesh routes of the engine, loader and CLI) on the CPU with
``gloo``.

Ranks are spawned with ``torch.multiprocessing`` (``tests/torch_ranks.py``)
and meet through a ``file://`` store in a temporary directory. Each group of
ranks runs all its cases once, in a module-scoped fixture, and writes its
results to a file; the tests hold them against the JAX package's mesh
results (computed here,
on the 8 virtual CPU devices of tests/conftest.py) or against the port's
own one-process run, which the port's other tests hold against JAX. Every
process group has a timeout, and the parent kills ranks that outlive their
deadline, so a collective that deadlocks fails a test instead of hanging.

Tolerances are the JAX package's own for the same checks:
tests/test_attn_pool.py (2e-5 on the pooled bag, 2e-4 on gradients),
tests/test_nystrom.py, tests/test_parallel.py (loss rtol 1e-5/1e-4, grad
norm 1e-4/1e-3, parameters within 2.5 lr, probabilities rtol 1e-4
atol 1e-5).
"""

from __future__ import annotations

import json
import os
import traceback

import numpy as np
import pytest
import torch

from tests.torch_ranks import ranks, spawn

# (a) pooling shapes, as tests/test_attn_pool.py:378
POOL = dict(b=4, n=512, df=32, l=16, a=16, k=3)
# (b) Nystrom shapes, as tests/test_nystrom.py:117
NYS = dict(b=2, h=4, n=256, dh=16, m=32)
# the zoo's tiny config (tests/conftest.py::tiny_conf) and bag
TINY = dict(n_class=2, D_feat=32, D_inner=16, n_token=3, n_masked_patch=5,
            mask_drop=0.5, lr=1e-3, train_epoch=3, min_bucket=64, seed=0)
ZOO_OVERRIDES = {
    "dtfd": {"numGroup": 4, "total_instance": 4, "grad_clipping": 5},
    "ips": {"ips_m": 64},
}
ZOO_B, ZOO_N = 4, 128
GA_B, GA_N = 4, 256
TM_N = 300


# ---------------------------------------------------------------------------
# inputs, made from seeds with numpy, the same in every process
# ---------------------------------------------------------------------------

def _pool_inputs():
    rs = np.random.RandomState(7)
    p = POOL
    feats = rs.randn(p["b"], p["n"], p["df"]).astype(np.float32)
    mask = rs.rand(p["b"], p["n"]) < 0.7
    mask[1, 256:] = False           # bag 1's second seq slice is empty
    mask[3] = False                 # bag 3 is all masked on every rank
    ws = [(rs.randn(*sh) * 0.3).astype(np.float32)
          for sh in [(p["df"], p["l"]), (p["l"],), (p["l"], p["a"]),
                     (p["a"],), (p["l"], p["a"]), (p["a"],),
                     (p["a"], p["k"]), (p["k"],)]]
    return feats, mask, ws


def _nys_inputs():
    rs = np.random.RandomState(0)
    p = NYS
    shape = (p["b"], p["h"], p["n"], p["dh"])
    q = (rs.randn(*shape) * 0.3).astype(np.float32)
    k = (rs.randn(*shape) * 0.3).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    mask = rs.rand(p["b"], p["n"]) < 0.85
    w = (rs.randn(p["h"], 33) * 0.1).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)     # the loss's weights
    return q, k, v, mask, w, r


def _zoo_bag(seed, b=ZOO_B, n=ZOO_N, d=32):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, d).astype(np.float32)
    mask = rs.rand(b, n) < 0.9
    mask[-1, n // 2:] = False
    idx = np.arange(n)
    step = 50000 // 64
    coords = np.broadcast_to(np.stack([(idx % 64) * step, (idx // 64) * step],
                                      -1), (b, n, 2)).astype(np.int32)
    return feats, mask, coords, rs.randint(0, 2, b)


def _torch_bag(feats, mask, coords, labels):
    from acmil_tpu_torch.data.bags import Bag

    return Bag(torch.from_numpy(np.ascontiguousarray(feats)),
               torch.from_numpy(np.ascontiguousarray(mask)),
               torch.from_numpy(np.ascontiguousarray(coords)),
               torch.from_numpy(np.asarray(labels, np.int64)))


def _zoo_conf(arch):
    from acmil_tpu_torch.config import Config

    d = dict(TINY, arch=arch)
    d.update(ZOO_OVERRIDES.get(arch, {}))
    return Config.from_dict(d)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _case_pool(inp):
    """(a): the sharded pooling, forward, lse and gradients, at data 2 x
    seq 2."""
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.parallel import collectives as C
    from acmil_tpu_torch.parallel import make_mesh, shard_bag

    mesh = make_mesh(2, 2)
    feats, mask, ws = _pool_inputs()
    b, n = mask.shape
    part = shard_bag(_torch_bag(feats, mask, np.zeros((b, n, 2), np.int32),
                                np.zeros(b)), mesh, shard_seq=True)
    x = part.feats.clone().requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    bag, logits = ap.sharded_gated_attn_pool_grad(x, part.mask, *wt,
                                                  mesh.seq_group)
    # the loss of tests/test_attn_pool.py:392: the bag term is replicated
    # over seq, the logits term is each slice's part, joined by a psum
    share = (bag ** 2).sum() + C.psum(1e-3 * torch.where(
        part.mask[:, None], torch.tanh(logits), 0.0).sum(), mesh.seq_group)
    share.backward()
    grads = [w.grad for w in wt]
    from acmil_tpu_torch.engine.train import sum_over_data_
    from acmil_tpu_torch.parallel.mesh import active

    with active(mesh):
        sum_over_data_(grads)
    loss = C.all_reduce_(share.detach().clone(), mesh.data_group)
    with torch.no_grad():
        b_, _, m, s = ap._pool_forward(part.feats, part.mask, *wt)
        _, lse = ap._merge_seq(b_, m, s, mesh.seq_group)
        inf_bag, inf_logits = ap.sharded_gated_attn_pool(
            part.feats, part.mask, *wt, mesh.seq_group)
    return {"bag": _np(bag), "logits": _np(logits), "lse": _np(lse),
            "loss": float(loss), "d_feats": _np(x.grad),
            "grads": [_np(g) for g in grads], "inf_bag": _np(inf_bag),
            "inf_logits": _np(inf_logits), "coord": (mesh.data_index,
                                                     mesh.seq_index)}


def _case_collectives(inp):
    """Each collective's forward and backward over the seq group of a data
    2 x seq 2 mesh, on ``x_r = r + 1 + arange(3)`` (r the seq rank)."""
    from acmil_tpu_torch.parallel import collectives as C
    from acmil_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2)
    g, r = mesh.seq_group, mesh.seq_index
    w = torch.arange(6.0) * 0.5               # a replicated loss weight
    out = {"seq_index": r}
    x = (r + 1 + torch.arange(3.0)).requires_grad_(True)
    y = C.all_gather(x, g, 0)
    (y * w).sum().backward()                  # replicated loss
    out["all_gather"] = (_np(y), _np(x.grad))
    x.grad = None
    y = C.psum(x, g)
    (y * w[:3]).sum().backward()
    out["psum"] = (_np(y), _np(x.grad))
    p = torch.ones(3, requires_grad=True)
    C.psum((C.fan_out(p, g) * x.detach()).sum(), g).backward()
    out["fan_out"] = _np(p.grad)
    out["pmax"] = (_np(C.pmax(x, g)), C.pmax(x, g).requires_grad)
    out["slice"] = _np(C.group_slice(torch.arange(6.0), g, 0))
    return out


def _case_nystrom(inp):
    """(b): the sharded Nystrom core and value conv, forward and
    gradients of sum(out * r), at data 2 x seq 2."""
    from acmil_tpu_torch.ops.nystrom import (sharded_depthwise_seq_conv,
                                             sharded_nystrom_attention)
    from acmil_tpu_torch.parallel import collectives as C
    from acmil_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2)
    q, k, v, mask, w, r = _nys_inputs()

    def local(a, seq_dim):
        t = torch.from_numpy(a)
        rows = t.shape[0] // mesh.data
        t = t[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return C.group_slice(t, mesh.seq_group, seq_dim).contiguous()

    ql, kl, vl = (local(a, 2).requires_grad_(True) for a in (q, k, v))
    ml, rl = local(mask, 1), local(r, 2)
    out = {}
    for masked in (True, False):
        for t in (ql, kl, vl):
            t.grad = None
        o = sharded_nystrom_attention(ql, kl, vl, ml if masked else None,
                                      NYS["m"], mesh.seq_group)
        (o * rl).sum().backward()
        tag = "masked" if masked else "unmasked"
        out[tag] = {"out": _np(o), "dq": _np(ql.grad), "dk": _np(kl.grad),
                    "dv": _np(vl.grad)}
    wt = torch.from_numpy(w).requires_grad_(True)
    vc = local(v, 2).requires_grad_(True)
    oc = sharded_depthwise_seq_conv(vc, wt, mesh.seq_group)
    (oc * rl).sum().backward()
    dw = C.all_reduce_(wt.grad.clone(), mesh.data_group)
    out["conv"] = {"out": _np(oc), "dv": _np(vc.grad), "dw": _np(dw)}
    out["coord"] = (mesh.data_index, mesh.seq_index)
    return out


def _case_ga_step(inp):
    """(c): one ACMIL_GA step with STKIM at data 2 x seq 2, from the JAX
    state's weights with the JAX step's uniforms."""
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import make_mesh, shard_bag, shard_params

    mesh = make_mesh(2, 2)
    conf = Config.from_dict(dict(TINY, arch="ga"))
    model, fam = build_mil_model(conf, mesh=mesh)
    model.load_state_dict(inp["ga_weights"])
    shard_params(model, mesh)
    state = create_train_state(model, conf, 10, family=fam)
    step = make_train_step(model, conf, fam, mesh=mesh)
    bag = shard_bag(_torch_bag(*inp["ga_bag"]), mesh, shard_seq=True)
    aux = step(state, bag, stkim_u=torch.from_numpy(inp["ga_u"]))
    return {"loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"]),
            "params": {k: _np(v) for k, v in model.state_dict().items()}}


def _transmil(conf_kw, mesh, weights):
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.models import build_mil_model

    conf = Config.from_dict(dict(TINY, arch="transmil", **conf_kw))
    model, fam = build_mil_model(conf, mesh=mesh)
    model.load_state_dict(weights)
    return conf, model, fam


def _case_transmil(inp):
    """(c): TransMIL at seq 2. The deterministic forward's loss and
    gradients (against JAX's mesh forward), then one training step with
    dropout (against the port's one-process step)."""
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.engine.losses import cross_entropy
    from acmil_tpu_torch.parallel import make_mesh, shard_bag, shard_params
    from acmil_tpu_torch.parallel.mesh import gather_seq

    mesh = make_mesh(1, 2)
    _, model, fam = _transmil({}, mesh, inp["tm_weights"])
    feats, mask, coords, labels = inp["tm_bag"]
    part = shard_bag(_torch_bag(feats, mask, coords, labels), mesh,
                     shard_seq=True)
    whole = gather_seq(part, mesh)
    logits = model(whole.feats, whole.mask)
    loss = cross_entropy(logits, whole.label)
    loss.backward()
    det = {"loss": float(loss), "logits": _np(logits),
           "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}
    conf, model, fam = _transmil({}, mesh, inp["tm_weights"])
    shard_params(model, mesh)
    state = create_train_state(model, conf, 10, family=fam)
    aux = make_train_step(model, conf, fam, mesh=mesh)(state, part)
    return {"det": det, "loss": float(aux["loss"]),
            "grad_norm": float(aux["grad_norm"]),
            "params": {k: _np(v) for k, v in model.state_dict().items()}}


def _zoo_run(arch, mesh):
    """One train step and one eval of ``arch`` at its tiny config on the zoo
    bag, on ``mesh`` (None: one process)."""
    from acmil_tpu_torch.engine import (create_train_state, make_eval_step,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import shard_bag, shard_params

    conf = _zoo_conf(arch)
    torch.manual_seed(0)
    model, fam = build_mil_model(conf, mesh=mesh)
    if mesh is not None:
        shard_params(model, mesh)
    bag = _torch_bag(*_zoo_bag(5))
    ebag = _torch_bag(*_zoo_bag(6))
    if mesh is not None:
        bag, ebag = shard_bag(bag, mesh), shard_bag(ebag, mesh)
    state = create_train_state(model, conf, 10, family=fam)
    aux = make_train_step(model, conf, fam, mesh=mesh)(state, bag)
    probs = make_eval_step(model, fam, mesh=mesh)(ebag)
    return {"loss": float(aux["loss"]),
            "grad_norm": float(aux.get("grad_norm", float("nan"))),
            "params": {k: _np(v) for k, v in model.state_dict().items()},
            "probs": _np(probs)}


def _zoo_archs():
    from acmil_tpu_torch.models import _REGISTRY

    return sorted(_REGISTRY)


def _case_zoo(inp):
    """(d): every registered arch at data 2."""
    from acmil_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1)
    out = {}
    for arch in _zoo_archs():
        try:
            out[arch] = _zoo_run(arch, mesh)
        except Exception:
            out[arch] = {"error": traceback.format_exc()}
    out["data_index"] = mesh.data_index
    return out


def _cli_argv(inp, tag, *extra):
    return ["--config", inp["cli_yaml"], "--data_dir", inp["cli_dir"],
            "--ckpt_dir", os.path.join(inp["cli_out"], tag, "ckpt"),
            "--log_dir", os.path.join(inp["cli_out"], tag, "log"),
            "--device", "cpu", "--seed", "0", *extra]


def _case_cli(inp):
    """(f): step3_acmil.main on a data 2 x seq 2 mesh (``mesh_shape`` in
    the YAML), then --resume for one more epoch."""
    from acmil_tpu_torch.cli import step3_acmil

    best = step3_acmil.main(_cli_argv(inp, "mesh", "--config",
                                      inp["cli_yaml_mesh"], "--train_epoch",
                                      "1"))
    resumed = step3_acmil.main(_cli_argv(inp, "mesh", "--config",
                                         inp["cli_yaml_mesh"], "--train_epoch",
                                         "2", "--resume"))
    return {"best": best, "resumed": resumed}


def _case_pod(inp):
    """(g): --pod with two processes (a data axis of 2)."""
    from acmil_tpu_torch.cli import step3_acmil

    return {"best": step3_acmil.main(_cli_argv(inp, "pod", "--pod",
                                               "--train_epoch", "1"))}


CASES = {"pool": _case_pool, "collectives": _case_collectives,
         "nystrom": _case_nystrom,
         "ga_step": _case_ga_step, "cli": _case_cli,
         "transmil": _case_transmil, "zoo": _case_zoo, "pod": _case_pod}


def _spawn(world, names, inputs, tmp):
    """Run the named cases on ``world`` spawned ranks
    (``tests/torch_ranks.py``)."""
    return spawn(world, [CASES[n] for n in names], inputs, tmp)


def _ranks(group, name):
    """Each rank's result of the named case, failing on a hung or failed
    rank."""
    return ranks(group, CASES[name])


# ---------------------------------------------------------------------------
# the JAX side and the groups of ranks
# ---------------------------------------------------------------------------

def _jax_ga_state():
    """The JAX ACMIL_GA train state, its bag and the uniforms of its first
    step's STKIM."""
    import jax
    import jax.numpy as jnp

    from acmil_tpu.config import Config as JaxConfig
    from acmil_tpu.data.bags import Bag as JaxBag
    from acmil_tpu.engine import create_train_state
    from acmil_tpu.models import build_mil_model
    from acmil_tpu.models import fast as jax_fast

    conf = JaxConfig.from_dict(dict(TINY, arch="ga"))
    model, fam = build_mil_model(conf)
    feats, mask, coords, labels = _zoo_bag(1, b=GA_B, n=GA_N)
    mask[1, GA_N // 2:] = False            # an empty seq slice
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.asarray(coords), label=jnp.asarray(labels,
                                                             jnp.int32))
    rng = jax.random.PRNGKey(0)
    state = create_train_state(model, conf, rng, jb, 10)
    s_rng, _ = jax.random.split(jax.random.fold_in(rng, 0))
    u = np.array(jax.random.uniform(jax_fast.derive_stkim_rng(s_rng),
                                    (GA_B, conf.n_token, GA_N), jnp.float32))
    return conf, model, fam, state, jb, rng, (feats, mask, coords, labels), u


def _jax_transmil():
    import jax
    import jax.numpy as jnp

    from acmil_tpu.config import Config as JaxConfig
    from acmil_tpu.models import build_mil_model

    conf = JaxConfig.from_dict(dict(TINY, arch="transmil"))
    model, _ = build_mil_model(conf)
    feats, mask, coords, labels = _zoo_bag(2, b=2, n=TM_N)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(feats),
                                 jnp.asarray(mask))["params"]
    return conf, params, (feats, mask, coords, labels)


def _write_cli_corpus(d):
    """A small torch feature file with a frozen split, and two YAMLs (the
    second with a data 2 x seq 2 ``mesh_shape``)."""
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
                mask_drop=0.5, lr=1e-3, train_epoch=1, min_bucket=64, B=2,
                split_dir=os.path.join(d, "splits"))
    paths = []
    for name, extra in (("one.yml", {}),
                        ("mesh.yml", {"mesh_shape": {"data": 2, "seq": 2}})):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(dict(base, **extra), f)
    return paths


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Cases (a), (b), (c) ACMIL_GA and (f) on four ranks, data 2 x seq 2."""
    from acmil_tpu_torch.models.convert import from_jax_params
    import jax

    tmp = str(tmp_path_factory.mktemp("world4"))
    _, _, _, state, _, _, bag, u = _jax_ga_state()
    cli_dir = os.path.join(tmp, "corpus")
    os.makedirs(cli_dir)
    yml, yml_mesh = _write_cli_corpus(cli_dir)
    inputs = {"ga_weights": from_jax_params(
                  jax.tree_util.tree_map(np.asarray, state.params), "ga"),
              "ga_bag": bag, "ga_u": u, "cli_yaml": yml,
              "cli_yaml_mesh": yml_mesh, "cli_dir": cli_dir,
              "cli_out": os.path.join(tmp, "runs")}
    group = _spawn(4, ["pool", "collectives", "nystrom", "ga_step", "cli"],
                   inputs,
                   os.path.join(tmp, "ranks"))
    group["inputs"] = inputs
    return group


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Cases (c) TransMIL, (d) and (g) on two ranks."""
    from acmil_tpu_torch.models.convert import from_jax_params
    import jax

    tmp = str(tmp_path_factory.mktemp("world2"))
    _, params, bag = _jax_transmil()
    cli_dir = os.path.join(tmp, "corpus")
    os.makedirs(cli_dir)
    yml, _ = _write_cli_corpus(cli_dir)
    inputs = {"tm_weights": from_jax_params(
                  jax.tree_util.tree_map(np.asarray, params), "transmil"),
              "tm_bag": bag, "cli_yaml": yml, "cli_dir": cli_dir,
              "cli_out": os.path.join(tmp, "runs")}
    group = _spawn(2, ["transmil", "zoo", "pod"], inputs,
                   os.path.join(tmp, "ranks"))
    group["inputs"] = inputs
    return group


def _slice(a, coord, data, seq, seq_dim):
    """Rank ``coord``'s rows of ``a`` and, for ``seq`` above 1, its slice
    along ``seq_dim``."""
    d, s = coord[0], coord[1] if seq > 1 else 0
    rows = a.shape[0] // data
    a = a[d * rows:(d + 1) * rows]
    n = a.shape[seq_dim] // seq
    return np.take(a, np.arange(s * n, (s + 1) * n), axis=seq_dim)


# ---------------------------------------------------------------------------
# (a) the sharded pooling
# ---------------------------------------------------------------------------

def test_sharded_pool_and_grad_match_jax(world4):
    import jax
    import jax.numpy as jnp

    from acmil_tpu.ops.attn_pool import (_sharded_pool_fwd_impl,
                                         sharded_gated_attn_pool_grad)
    from acmil_tpu.parallel import make_mesh

    feats, mask, ws = _pool_inputs()
    mesh = make_mesh(data=2, seq=2)
    jf, jm = jnp.asarray(feats), jnp.asarray(mask)
    jws = [jnp.asarray(w) for w in ws]

    def loss_fn(f, *w):
        bag, logits = sharded_gated_attn_pool_grad(f, jm, *w, mesh, 128)
        return (bag ** 2).sum() + 1e-3 * jnp.where(
            jm[:, None], jnp.tanh(logits), 0.0).sum()

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            loss_fn, argnums=tuple(range(9))))(jf, *jws)
        bag, logits, lse = jax.jit(lambda f, *w: _sharded_pool_fwd_impl(
            f, jm, *w, mesh, 128, "data", "seq"))(jf, *jws)
    bag, logits, lse = (np.asarray(t) for t in (bag, logits, lse))
    grads = [np.asarray(g) for g in grads]
    for got in _ranks(world4, "pool"):
        c = got["coord"]
        np.testing.assert_allclose(got["bag"], _slice(bag, c, 2, 1, 1),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["inf_bag"], got["bag"], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(got["lse"], _slice(lse, c, 2, 1, 1),
                                   rtol=2e-5, atol=2e-5)
        valid = _slice(mask, c, 2, 2, 1)[:, None]
        for name in ("logits", "inf_logits"):
            np.testing.assert_allclose(
                np.where(valid, got[name], 0.0),
                np.where(valid, _slice(logits, c, 2, 2, 2), 0.0),
                rtol=2e-5, atol=2e-5)
        assert np.isfinite(got["bag"]).all() and np.isfinite(got["lse"]).all()
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(got["d_feats"],
                                   _slice(grads[0], c, 2, 2, 1),
                                   rtol=2e-4, atol=2e-4)
        for g, w in zip(got["grads"], grads[1:]):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    # the all-masked bag pools to 0 on every rank
    assert all(np.all(r["bag"][-1] == 0) for r in _ranks(world4, "pool")
               if r["coord"][0] == 1)


def test_collectives_forward_and_backward(world4):
    """psum's backward passes the replicated gradient, all_gather's keeps
    this rank's slice, fan_out's sums over the group; pmax has none."""
    w = np.arange(6.0) * 0.5
    xs = [r + 1 + np.arange(3.0) for r in range(2)]
    for got in _ranks(world4, "collectives"):
        r = got["seq_index"]
        y, dx = got["all_gather"]
        np.testing.assert_array_equal(y, np.concatenate(xs))
        np.testing.assert_array_equal(dx, w[3 * r:3 * r + 3])
        y, dx = got["psum"]
        np.testing.assert_array_equal(y, xs[0] + xs[1])
        np.testing.assert_array_equal(dx, w[:3])
        np.testing.assert_array_equal(got["fan_out"], xs[0] + xs[1])
        m, needs_grad = got["pmax"]
        np.testing.assert_array_equal(m, np.maximum(xs[0], xs[1]))
        assert not needs_grad
        np.testing.assert_array_equal(got["slice"], np.arange(6.0)[3 * r:
                                                                   3 * r + 3])


# ---------------------------------------------------------------------------
# (b) the sharded Nystrom core and conv
# ---------------------------------------------------------------------------

def test_sharded_nystrom_and_conv_match_jax(world4):
    import jax
    import jax.numpy as jnp

    from acmil_tpu.ops.nystrom import (sharded_depthwise_seq_conv,
                                       sharded_nystrom_attention)
    from acmil_tpu.parallel import make_mesh
    from acmil_tpu_torch.ops.nystrom import depthwise_seq_conv, nystrom_attention

    q, k, v, mask, w, r = _nys_inputs()
    mesh = make_mesh(data=2, seq=2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    @jax.jit
    def run(q, k, v, mask, w):
        return (sharded_nystrom_attention(q, k, v, mask, mesh, NYS["m"],
                                          data_axis="data"),
                sharded_nystrom_attention(q, k, v, None, mesh, NYS["m"],
                                          data_axis="data"),
                sharded_depthwise_seq_conv(v, w, mesh, data_axis="data"))

    masked, unmasked, want_conv = (np.asarray(t) for t in run(
        jq, jk, jv, jnp.asarray(mask), jnp.asarray(w)))
    want = {"masked": masked, "unmasked": unmasked}
    # the gradients: the port's one-process core under autograd
    grads = {}
    for tag, m in (("masked", mask), ("unmasked", None)):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        out, _ = nystrom_attention(tq, tk, tv, None if m is None
                                   else torch.from_numpy(m), NYS["m"])
        (out * torch.from_numpy(r)).sum().backward()
        grads[tag] = [t.grad.numpy() for t in (tq, tk, tv)]
    # in float64: the CPU's float32 depthwise-conv weight gradient is itself
    # off by up to 4% of its largest entry here
    tv, tw = (torch.from_numpy(a).double().requires_grad_(True)
              for a in (v, w))
    (depthwise_seq_conv(tv, tw) * torch.from_numpy(r).double()).sum(
        ).backward()
    for got in _ranks(world4, "nystrom"):
        c = got["coord"]
        for tag in ("masked", "unmasked"):
            np.testing.assert_allclose(got[tag]["out"],
                                       _slice(want[tag], c, 2, 2, 2),
                                       rtol=2e-4, atol=2e-5)
            for name, g in zip(("dq", "dk", "dv"), grads[tag]):
                np.testing.assert_allclose(got[tag][name],
                                           _slice(g, c, 2, 2, 2),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{tag} {name}")
        np.testing.assert_allclose(got["conv"]["out"],
                                   _slice(want_conv, c, 2, 2, 2),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["conv"]["dv"],
                                   _slice(tv.grad.numpy(), c, 2, 2, 2),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["conv"]["dw"], tw.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (c) one ACMIL_GA step and TransMIL at seq 2
# ---------------------------------------------------------------------------

def test_acmil_ga_stkim_step_matches_jax_mesh_step(world4):
    import jax

    from acmil_tpu.engine import make_train_step
    from acmil_tpu.parallel import make_mesh, shard_bag, shard_params
    from acmil_tpu_torch.models.convert import from_jax_params

    conf, model, fam, state, jb, rng, _, _ = _jax_ga_state()
    mesh = make_mesh(data=2, seq=2)
    with mesh:
        state = shard_params(state, mesh)
        step = make_train_step(model, conf, fam, mesh=mesh)
        state, aux = step(state, shard_bag(jb, mesh, shard_seq=True), rng)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                           "ga")
    ranks = _ranks(world4, "ga_step")
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(aux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(aux["grad_norm"]),
                                   rtol=1e-4)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want[name].numpy(),
                                       atol=2.5 * conf.lr, err_msg=name)
    # every rank holds the same parameters
    for got in ranks[1:]:
        for name, p in got["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][name])


def test_transmil_at_seq_2_matches_jax_and_one_process(world2):
    import jax
    import jax.numpy as jnp

    from acmil_tpu.engine import losses as jax_losses
    from acmil_tpu.models import build_mil_model as jax_build
    from acmil_tpu.parallel import make_mesh
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models.convert import from_jax_params

    jconf, params, (feats, mask, coords, labels) = _jax_transmil()
    mesh = make_mesh(data=1, seq=2, devices=jax.devices()[:2])
    jm, _ = jax_build(jconf, mesh=mesh)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(feats),
                          jnp.asarray(mask), deterministic=True)
        return jax_losses.cross_entropy(logits, jnp.asarray(labels,
                                                            jnp.int32))

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, grads),
                           "transmil")
    scale = max(float(g.abs().max()) for g in want.values())
    # the step: the port's one-process step on the same weights and draws
    conf, model, fam = _transmil({}, None, world2["inputs"]["tm_weights"])
    state = create_train_state(model, conf, 10, family=fam)
    aux = make_train_step(model, conf, fam)(state, _torch_bag(
        feats, mask, coords, labels))
    one = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for got in _ranks(world2, "transmil"):
        det = got["det"]
        # the Nystrom tolerance of tests/test_torch_transmil.py
        np.testing.assert_allclose(det["loss"], float(loss), rtol=1e-4)
        for name, g in det["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(),
                                       atol=1e-4 * scale, rtol=1e-3,
                                       err_msg=name)
        np.testing.assert_allclose(got["loss"], float(aux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(aux["grad_norm"]),
                                   rtol=1e-4)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, one[name], atol=2.5 * conf.lr,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# (d) every registered arch at data 2 against the port's one-process run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _zoo_archs())
def test_zoo_step_and_eval_at_data_2_match_one_process(world2, arch):
    want = _zoo_run(arch, None)
    ranks = _ranks(world2, "zoo")
    for got in ranks:
        got = got[arch]
        assert "error" not in got, got["error"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-3)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want["params"][name],
                                       atol=2.5 * TINY["lr"], err_msg=name)
    probs = np.concatenate([r[arch]["probs"] for r in
                            sorted(ranks, key=lambda r: r["data_index"])])
    assert probs.shape == (ZOO_B, TINY["n_class"])
    np.testing.assert_allclose(probs, want["probs"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) the loader on a mesh, and its refusals
# ---------------------------------------------------------------------------

def _fake_mesh(data, seq, rank):
    from acmil_tpu_torch.parallel import Mesh

    return Mesh(data, seq, rank, torch.device("cpu"))


def test_loader_plans_pads_and_slices_per_rank():
    from acmil_tpu_torch.data import BagLoader
    from tests.conftest import make_synthetic_bags

    class Src:
        def __init__(self, slides):
            self.names = sorted(slides)
            self.slides = slides

        def __len__(self):
            return len(self.names)

        def lengths(self):
            return [len(self.slides[n]["feat"]) for n in self.names]

        def __getitem__(self, i):
            s = self.slides[self.names[i]]
            return {"input": s["feat"], "coords": s["coords"],
                    "label": s["label"]}

    slides = make_synthetic_bags(n_slides=11, d=8, seed=0, min_len=40,
                                 max_len=120)
    src = Src(slides)
    whole = [b for b in BagLoader(src, 4, shuffle=True, seed=3,
                                  min_bucket=64, prefetch=0)]
    parts = {r: list(BagLoader(src, 4, shuffle=True, seed=3, min_bucket=64,
                               prefetch=0, mesh=_fake_mesh(2, 2, r)))
             for r in range(4)}
    assert all(len(p) == len(whole) for p in parts.values())
    for i, w in enumerate(whole):
        b, n = w.mask.shape
        for r, p in parts.items():
            got = p[i]
            d, s = r // 2, r % 2
            assert got.feats.shape == (2, n // 2, 8)
            rows = slice(2 * d, 2 * d + 2)
            cols = slice(s * n // 2, (s + 1) * n // 2)
            real = min(max(b - 2 * d, 0), 2)
            np.testing.assert_array_equal(got.feats[:real].numpy(),
                                          w.feats[rows, cols].numpy())
            np.testing.assert_array_equal(got.mask[:real].numpy(),
                                          w.mask[rows, cols].numpy())
            # a ragged batch's pad rows: all masked, label 0
            assert not got.mask[real:].any()
            assert (got.label[real:] == 0).all()
            np.testing.assert_array_equal(got.label[:real].numpy(),
                                          w.label[rows].numpy())


def test_loader_and_shard_bag_refuse_what_does_not_split():
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.parallel import shard_bag

    with pytest.raises(ValueError, match="data axis"):
        BagLoader([], 3, mesh=_fake_mesh(2, 1, 0))
    bag = _torch_bag(*_zoo_bag(0, b=2, n=6))
    with pytest.raises(ValueError, match="seq axis"):
        shard_bag(bag, _fake_mesh(1, 4, 0), shard_seq=True)
    with pytest.raises(ValueError, match="data axis"):
        shard_bag(bag, _fake_mesh(4, 1, 0))


def test_mesh_layout_needs_the_world_size():
    from acmil_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        make_mesh(2, 2)
    mesh = make_mesh()
    assert (mesh.data, mesh.seq, mesh.world) == (1, 1, 1)
    assert mesh.data_group is None and mesh.seq_group is None


# ---------------------------------------------------------------------------
# the collectives' backward, and the world-1 identities
# ---------------------------------------------------------------------------

def test_collectives_are_identities_at_world_1():
    from acmil_tpu_torch.parallel import collectives as C

    x = torch.randn(3, 4, requires_grad=True)
    for fn in (lambda t: C.psum(t, None), lambda t: C.fan_out(t, None),
               lambda t: C.all_gather(t, None, 1)):
        y = fn(x)
        assert y is x
    assert torch.equal(C.pmax(x, None), x.detach())
    assert C.gather_list(x, None)[0] is x
    assert C.group_slice(x, None, 1) is x


# ---------------------------------------------------------------------------
# (f) step3_acmil on a data 2 x seq 2 mesh, and (g) --pod
# ---------------------------------------------------------------------------

def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_step3_on_a_mesh_matches_one_process(world4, tmp_path):
    from acmil_tpu_torch.cli import step3_acmil

    inp = world4["inputs"]
    want = step3_acmil.main(_cli_argv(dict(inp, cli_out=str(tmp_path)), "one",
                                      "--train_epoch", "1"))
    ranks = _ranks(world4, "cli")
    for got in ranks:
        assert got["best"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got["best"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert got["resumed"]["epoch"] in (0, 1)
    # one writer: one log with each epoch once, and the checkpoints
    out = os.path.join(inp["cli_out"], "mesh")
    rows = [r for r in _jsonl(os.path.join(out, "log", "metrics.jsonl"))
            if "_config" not in r]
    assert len(rows) == 2                  # epoch 0, then the resumed 1
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "checkpoint-best.pth", "checkpoint-last.pth"]
    ck = torch.load(os.path.join(out, "ckpt", "checkpoint-last.pth"),
                    weights_only=False)
    assert ck["epoch"] == 1


def test_pod_with_two_processes_matches_one_process(world2, tmp_path):
    from acmil_tpu_torch.cli import step3_acmil

    inp = world2["inputs"]
    want = step3_acmil.main(_cli_argv(dict(inp, cli_out=str(tmp_path)), "one",
                                      "--train_epoch", "1"))
    for got in _ranks(world2, "pod"):
        for k, v in want.items():
            np.testing.assert_allclose(got["best"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
