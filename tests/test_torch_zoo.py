"""The port's generic zoo heads without a family of their own
(acmil_tpu_torch: models/mean_max.py, lbmil.py, attmil.py, ilra.py,
ips.py, their registry entries and converters, the default family, and
cli/step3_generic.py, cli/predict.py and cli/step4_heatmap.py on them)
against the JAX package, on the same numpy inputs and the same weights.

None of these heads reaches a Pallas kernel in the JAX package, so both
sides run plain forwards. Everything is float32: XLA and torch sum in other
orders, so outputs agree within ATOL/RTOL at valid positions (C3) and
gradients within GRAD_ATOL/GRAD_RTOL, with dropout off on both sides.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from acmil_tpu.cli import train as jax_cli
from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine import make_train_step as jax_make_step
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models.attmil import DAttentionMIL as JaxAttMIL
from acmil_tpu.models.ilra import ILRA as JaxILRA
from acmil_tpu.models.ips import IPSNet as JaxIPS
from acmil_tpu.models.lbmil import LBMIL as JaxLBMIL
from acmil_tpu.models.mean_max import MaxMIL as JaxMaxMIL
from acmil_tpu.models.mean_max import MeanMIL as JaxMeanMIL
from acmil_tpu_torch.cli import predict, step3_generic, step4_heatmap
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_train_step)
from acmil_tpu_torch.models import (ILRA, LBMIL, DAttentionMIL, IPSNet,
                                    MaxMIL, MeanMIL, build_mil_model)
from acmil_tpu_torch.models.convert import from_jax_params
from scripts.import_torch_checkpoint import (convert_attmil, convert_ilra,
                                             convert_lbmil, convert_mean_max)
from tests.conftest import make_synthetic_bags

D, L, A, STEM = 32, 16, 16, 24
ILRA_HIDDEN, ILRA_HEADS = 16, 4
IPS_M, IPS_CHUNK = 32, 16
ATOL, RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-3
ARCHS = ["meanmil", "maxmil", "lbmil", "attmil", "attmil_gated", "ilra",
         "ips"]
CONVERTERS = {"meanmil": convert_mean_max, "maxmil": convert_mean_max,
              "lbmil": convert_lbmil, "attmil": convert_attmil,
              "attmil_gated": convert_attmil, "ilra": convert_ilra}
# every arch this slice registers, with the family the JAX registry gives
ZOO = ARCHS + ["ibmil", "bmil_vis", "bmil_enc", "bmil_spvis"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _modules(arch, n_class=3, droprate=0.0):
    """(flax module, port module) at the test widths."""
    if arch in ("meanmil", "maxmil"):
        jcls, tcls = ((JaxMeanMIL, MeanMIL) if arch == "meanmil"
                      else (JaxMaxMIL, MaxMIL))
        return (jcls(n_class=n_class, d_inner=L, droprate=droprate),
                tcls(n_class, D, L, droprate=droprate))
    if arch == "lbmil":
        return JaxLBMIL(n_class=n_class, d_inner=L), LBMIL(n_class, D, L)
    if arch in ("attmil", "attmil_gated"):
        gated = arch == "attmil_gated"
        return (JaxAttMIL(n_class=n_class, d_stem=STEM, d_attn=A, gated=gated,
                          droprate=droprate),
                DAttentionMIL(n_class, D, STEM, A, gated=gated,
                              droprate=droprate))
    if arch == "ilra":
        return (JaxILRA(n_class=n_class, hidden_feat=ILRA_HIDDEN,
                        num_heads=ILRA_HEADS),
                ILRA(n_class, D, hidden_feat=ILRA_HIDDEN,
                     num_heads=ILRA_HEADS))
    return (JaxIPS(n_class=n_class, d_inner=L, d_attn=A, m_keep=IPS_M,
                   chunk=IPS_CHUNK),
            IPSNet(n_class, D, L, A, IPS_M))


@functools.lru_cache(maxsize=None)
def _shapes(arch, n_class, droprate):
    """The flax head's parameter tree of ``jax.ShapeDtypeStruct``s."""
    jm = _modules(arch, n_class, droprate)[0]
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, D)), jnp.ones((1, 8), bool))["params"]


def _pair(arch, n_class=3, seed=0, droprate=0.0):
    """The flax head with every parameter drawn from a seeded normal (biases
    too) and the port's module holding the same weights."""
    jm, tm = _modules(arch, n_class, droprate)
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        _shapes(arch, n_class, droprate))
    tm.load_state_dict(from_jax_params(params, arch, droprate))
    return jm, params, tm.eval()


@functools.lru_cache(maxsize=None)
def _jit_apply(jm):
    return jax.jit(functools.partial(jm.apply, deterministic=True))


def _bag_arrays(seed, b=3, n=300, n_class=3):
    """Bag 0 mostly valid, bag 1 with 10 valid rows, bag 2 all masked."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    if b > 1:
        mask[1] = False
        mask[1, rs.choice(n, 10, replace=False)] = True
    if b > 2:
        mask[2] = False
    return feats, mask, rs.randint(0, n_class, b)


def _bags(feats, mask, labels):
    coords = np.zeros(feats.shape[:2] + (2,), np.int32)
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.asarray(coords),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.from_numpy(coords),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Registry, weights and converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
def test_registry_builds_with_the_jax_family(arch, tmp_path):
    d = dict(arch=arch, n_class=3, D_feat=D, D_inner=L, seed=1, ips_m=7)
    if arch == "ibmil":
        np.save(tmp_path / "p.npy", np.ones((4, L), np.float32))
        d["c_path"] = str(tmp_path / "p.npy")
    model, family = build_mil_model(Config.from_dict(d))
    assert family == jax_build_model(JaxConfig.from_dict(d))[1]
    if arch == "ips":
        assert model.m_keep == 7
    if arch == "ibmil":
        assert model.confounder_feat.shape == (4, L)
        assert "confounder_feat" in dict(model.named_buffers())


@pytest.mark.parametrize("arch, droprate", [
    ("meanmil", 0.25), ("meanmil", 0.0), ("maxmil", 0.25), ("lbmil", 0.0),
    ("attmil", 0.25), ("attmil_gated", 0.0), ("ilra", 0.0)])
def test_convert_round_trip_gives_the_jax_tree(arch, droprate):
    """The port's state_dict → the reference converter → the flax tree that
    ``from_jax_params`` started from, exactly."""
    jm, params, tm = _pair(arch, droprate=droprate)
    got = CONVERTERS[arch]({k: v.numpy() for k, v in tm.state_dict().items()})
    want_leaves, want_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_distributions(arch):
    """Registry builds at the serving widths: every port tensor has its
    JAX twin's zeros and, where it is large enough to tell, its spread
    (xavier-normal, torch-linear uniform, xavier-uniform latents)."""
    d = dict(arch=arch, n_class=2, D_feat=384, D_inner=128, seed=3)
    jm, _ = jax_build_model(JaxConfig.from_dict(d))
    want = from_jax_params(_init_wide(jm), arch, 0.25)
    tm, _ = build_mil_model(Config.from_dict(d))
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not w.any():
            assert not g.any(), k
        elif w.numel() >= 1000:
            ratio = float(g.std() / w.std())
            assert 0.9 < ratio < 1.1, (k, ratio)


def _init_wide(jm):
    return _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8, 384)),
                                     jnp.ones((1, 8), bool))["params"])


# ---------------------------------------------------------------------------
# The modules against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [300, 20])
def test_module_matches_flax(arch, n):
    """n=300 runs IPS's selection (the JAX module's streamed top-M buffer
    over 16-row chunks, a ragged last one); n=20 <= M its keep-all
    branch."""
    jm, params, tm = _pair(arch, seed=1)
    feats, mask, _ = _bag_arrays(2, n=n)
    want = np.asarray(_jit_apply(jm)({"params": params}, jnp.asarray(feats),
                                     jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    _close(got.numpy(), want, name=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_slots_are_inert_and_an_empty_bag_is_finite(arch):
    """Garbage in the padded slots changes no output (as
    tests/test_model_zoo.py holds the JAX heads), and an all-masked bag
    gives finite logits and gradients."""
    _, _, tm = _pair(arch, seed=6)
    feats, mask, _ = _bag_arrays(7)
    garbage = feats.copy()
    rs = np.random.RandomState(8)
    garbage[~mask] = 1e3 * rs.randn(int((~mask).sum()), D)
    with torch.no_grad():
        a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
        b = tm(torch.from_numpy(garbage), torch.from_numpy(mask))
    # bag 2 has no valid slot: LBMIL then weighs its pads alike, in both
    # packages, so only bags with a valid slot are held to this
    _close(b.numpy()[:2], a.numpy()[:2], atol=1e-4, rtol=1e-4)
    feats[~mask] = 0.0                         # the loader's padding
    out = tm.train()(torch.from_numpy(feats[2:]), torch.from_numpy(mask[2:]),
                     deterministic=False)
    assert torch.isfinite(out).all()
    out.sum().backward()
    for name, p in tm.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("arch", ["meanmil", "attmil"])
def test_dropout_runs_only_in_training_with_the_generator(arch):
    _, _, tm = _pair(arch, seed=9, droprate=0.25)
    x = torch.from_numpy(_bag_arrays(10, b=1)[0])
    plain = tm(x)
    assert torch.equal(tm(x, deterministic=False), plain)    # eval mode
    tm.train()
    assert torch.equal(tm(x), plain)                          # deterministic
    draw = [tm(x, deterministic=False,
               generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], plain)


# ---------------------------------------------------------------------------
# Training: one step, five AdamW steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_loss_and_grads_match_jax(arch):
    """The default family's loss and every gradient at dropout 0. IPS's
    scorer gets no gradient on either side."""
    jm, params, tm = _pair(arch, seed=11)
    jb, tb = _bags(*_bag_arrays(12))
    conf = dict(arch=arch, n_class=3, D_feat=D, D_inner=L)
    jfam, fam = jax_get_family("default"), get_family("default")
    jconf_d = jfam.conf_dict(JaxConfig.from_dict(conf))
    conf_d = fam.conf_dict(Config.from_dict(conf))

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb,
                                 {"dropout": jax.random.PRNGKey(0)}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm.train()
    loss, _ = fam.loss(fam.train_outputs(tm, tb, conf_d), tb,
                       tb.mask.any(dim=1), conf_d)
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    want = from_jax_params(_np_tree(grads_j), arch, 0.0)
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)
    if arch == "ips":
        assert all(tm.get_parameter(n).grad is None for n in got
                   if n.startswith("scorer."))


def _shift_invariant(arch, name, shape):
    """The elements whose gradient is 0 in exact arithmetic: a bias that
    shifts every logit of a softmax alike (the attention output's bias;
    ILRA's key biases, ``fc_k`` and the key third of the in-projection).
    Both packages step them by AdamW-normalised rounding noise."""
    m = np.zeros(shape, bool)
    if name in ({"attmil": "attention.2.bias",
                 "ips": "attention.attention_weights.bias"}.get(arch),) \
            or name.endswith("fc_k.bias"):
        m[...] = True
    if name.endswith("in_proj_bias"):
        m[shape[0] // 3:2 * shape[0] // 3] = True
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_five_adamw_steps_match_jax(arch):
    """Five steps of each package's trainer from the same weights. IPS runs
    at a weight decay large enough that its scorer, which only the decay
    moves, moves measurably; both packages must move it alike."""
    wd = 0.05 if arch == "ips" else 1e-5
    d = dict(arch=arch, n_class=3, D_feat=D, D_inner=L, lr=1e-3, wd=wd,
             train_epoch=2, seed=0)
    jconf, conf = JaxConfig.from_dict(d), Config.from_dict(d)
    jm, _, tm = _pair(arch, seed=13)
    # one bag shape, so the JAX step compiles once
    bags = [_bags(*_bag_arrays(30 + i, b=1, n=100)) for i in range(3)]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 3)
    p0 = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    tm.load_state_dict(p0)
    state = create_train_state(tm, conf, 3)
    jstep = jax_make_step(jm, jconf, "default")
    step = make_train_step(tm, conf, "default")
    for i in range(5):
        jb, tb = bags[i % 3]
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    for name, p in tm.named_parameters():
        d_want = (want[name] - p0[name]).numpy()
        d_got = p.detach().numpy() - p0[name].numpy()
        noise = _shift_invariant(arch, name, d_want.shape)
        if noise.any():
            assert np.abs(d_got[noise]).max() <= 5 * conf.lr * (1 + 1e-3)
        if noise.all():
            continue
        d_want, d_got = d_want[~noise], d_got[~noise]
        if not d_want.any():
            # ILRA's latent -> bag attention has one key (num_inds 1): its
            # softmax is 1 and its key path gets an exact 0 in both
            assert not d_got.any(), name
            continue
        # each step rounds the parameter to f32: a few ulps of it on top.
        # AdamW scales each element by its own gradient's size, so an
        # element whose gradient is within the packages' rounding of 0
        # (GRAD_ATOL) steps differently: at most 1% of the elements may
        # miss, each by at most 2% of the largest five-step move (5 lr)
        ulps = 5 * np.spacing(np.abs(p0[name].numpy()).max())
        tol = 1e-4 * np.abs(d_want).max() + ulps + 1e-3 * np.abs(d_want)
        miss = np.abs(d_got - d_want) > tol
        assert miss.mean() <= 0.01, (name, int(miss.sum()), miss.size)
        _close(d_got, d_want, atol=0.02 * 5 * conf.lr, rtol=0, name=name)
    if arch == "ips":
        # decay alone: p_5 = p_0 prod_t (1 - lr_t wd)
        w0 = p0["scorer.attention_weights.weight"].numpy()
        got = tm.scorer.attention_weights.weight.detach().numpy()
        decay = np.prod([1 - state.schedule(t) * wd for t in range(5)])
        _close(got, w0 * decay, atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLIs: Step3 training, predict, Step4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small H5 dump with a frozen split file, the same bags as a torch
    feature file, and a YAML naming both."""
    d = tmp_path_factory.mktemp("zoo")
    slides = make_synthetic_bags(n_slides=12, d=D, seed=7, min_len=10,
                                 max_len=200)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:10],
                   "test_names": names[10:]}, f)
    return d, slides


def _run_conf(d, tag, arch, **kw):
    out = dict(dataset="camelyon", n_class=2, D_feat=D, D_inner=L, arch=arch,
               lr=1e-3, train_epoch=2, min_bucket=256, seed=0,
               pretrain="tiny", data_dir=str(d), split_dir=str(d / "splits"),
               ckpt_dir=str(d / tag / "ckpt"), log_dir=str(d / tag / "log"),
               ips_m=IPS_M, ips_chunk=IPS_CHUNK)
    out.update(kw)
    return out


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "_config" not in r]


def _ips_to_jax(sd):
    """The port's IPS state dict → the flax tree (IPS has no reference
    converter): the inverse of ``from_jax_params(..., "ips")``."""
    def lin(prefix):
        out = {"kernel": sd[f"{prefix}.weight"].numpy().T}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"].numpy()
        return out

    def gated(prefix):
        return {"Dense_0": lin(f"{prefix}.attention_V.0"),
                "Dense_1": lin(f"{prefix}.attention_U.0"),
                "Dense_2": lin(f"{prefix}.attention_weights")}

    return {"DimReduction_0": {"Dense_0": lin("dimreduction.fc1")},
            "AttentionGated_0": gated("scorer"),
            "AttentionGated_1": gated("attention"),
            "Classifier1fc_0": {"Dense_0": lin("classifier.fc")}}


def _predict_against_jax(d, slides, arch, ckpt_dir, tmp_path, to_jax):
    """``cli/predict.py`` on the checkpoint against the JAX eval step on
    the same weights."""
    pyml = tmp_path / "predict.yml"
    pyml.write_text(yaml.safe_dump({"n_class": 2, "arch": "ga",
                                    "ips_m": IPS_M}))
    res = predict.main(["--config", str(pyml), "--ckpt", ckpt_dir,
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert len(res["rows"]) == len(slides)
    ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
    jm, family = jax_build_model(JaxConfig.from_dict(_run_conf(d, "", arch)))
    jstep = jax_make_eval_step(jm, family)
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax(ck["model"]))
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                dtype=np.float16)
        _close(row[2:4], np.asarray(jstep(jparams, jbag))[0], name=row[0])
        assert row[-1] == int(np.argmax(row[2:4]))


@pytest.mark.parametrize("arch", ["lbmil", "ips"])
def test_step3_generic_trains_and_scores_as_jax(corpus, monkeypatch,
                                                tmp_path, arch):
    """Two epochs of ``cli/step3_generic.py --arch ARCH --device cpu``
    against ``acmil_tpu.cli.train.run_training`` from the same weights (both
    heads train without dropout), then ``cli/predict.py`` on the best
    checkpoint against the JAX eval step."""
    d, slides = corpus
    jconf = JaxConfig.from_dict(_run_conf(d, f"jax_{arch}", arch))
    jax_best = jax_cli.run_training(jconf)
    p_rng, s_rng, d_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    jm, _ = jax_build_model(jconf)
    params = jm.init({"params": p_rng, "stkim": s_rng, "dropout": d_rng},
                     jnp.zeros((1, 256, D)), jnp.ones((1, 256), bool))["params"]
    real_build = port_cli.build_mil_model

    def build_from_jax(c):
        model, family = real_build(c)
        model.load_state_dict(from_jax_params(_np_tree(params), arch))
        return model, family

    monkeypatch.setattr(port_cli, "build_mil_model", build_from_jax)
    yml = d / f"port_{arch}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, f"port_{arch}", arch)))
    best = step3_generic.main(["--config", str(yml), "--device", "cpu"])
    want = _epochs(jconf.log_dir)
    got = _epochs(str(d / f"port_{arch}" / "log"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train/loss", "perf/val_loss", "perf/test_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
        for key in ("perf/val_auc", "perf/test_auc", "perf/test_acc"):
            assert g[key] == w[key], key
    assert best["epoch"] == jax_best["epoch"]
    to_jax = _ips_to_jax if arch == "ips" else (
        lambda sd: convert_lbmil({k: v.numpy() for k, v in sd.items()}))
    _predict_against_jax(d, slides, arch, str(d / f"port_{arch}" / "ckpt"),
                         tmp_path, to_jax)


@pytest.mark.parametrize("arch", ["meanmil", "maxmil", "attmil",
                                  "attmil_gated", "ilra"])
def test_step3_generic_trains_the_registry_build_and_predict_scores_it(
        corpus, tmp_path, arch):
    """One epoch of the registry's build (dropout 0.25 where the JAX
    registry has it, so the losses are the port's own), finite; then
    ``cli/predict.py`` against the JAX eval step on the checkpoint's weights
    through the reference converter."""
    d, slides = corpus
    yml = d / f"reg_{arch}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, f"reg_{arch}", arch,
                                            train_epoch=1)))
    step3_generic.main(["--config", str(yml), "--device", "cpu"])
    got = _epochs(str(d / f"reg_{arch}" / "log"))
    assert len(got) == 1 and np.isfinite(got[0]["train/loss"])
    _predict_against_jax(
        d, slides, arch, str(d / f"reg_{arch}" / "ckpt"), tmp_path,
        lambda sd: CONVERTERS[arch]({k: v.numpy() for k, v in sd.items()}))


@pytest.mark.parametrize("arch", ARCHS)
def test_step4_refuses_a_head_without_attention(arch):
    """As the JAX Step4 (`Step4_visualize_heatmap_camelyon.py:76-86`): a
    head that returns bare logits has no heatmap."""
    _, _, tm = _pair(arch, seed=14)
    x = torch.from_numpy(_bag_arrays(15, b=1)[0])
    with pytest.raises(ValueError, match="model emits no attention"):
        step4_heatmap.attention_probs(tm, Bag(x, torch.ones(
            x.shape[:2], dtype=torch.bool), None, None))
