"""The port's TransMIL (acmil_tpu_torch/models/transmil.py, its registry
entry and converter, and cli/step3_generic.py, cli/predict.py and
cli/step4_heatmap.py on it) against the JAX package, on the same numpy
inputs and the same weights.

TransMIL reaches no Pallas kernel in the JAX package. Its Nystrom
pseudo-inverse amplifies the packages' f32 summation orders, so logits,
attention rows and gradients are held to ATOL/RTOL, the JAX-vs-reference
Nystrom tolerance (tests/test_reference_parity.py::test_nystrom_core_parity);
bf16 to BF16_ATOL/BF16_RTOL (tests/test_model_zoo.py::
test_transmil_bf16_matches_f32). TransLayer's attention dropout 0.1 is fixed,
so gradients come from a loss on the deterministic forward, and training is
held to finite losses rather than to JAX's.
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

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data import write_feature_h5
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine.losses import cross_entropy as jax_ce
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models.transmil import TransMIL as JaxTransMIL
from acmil_tpu_torch.cli import predict, step3_generic, step4_heatmap
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.engine.losses import cross_entropy
from acmil_tpu_torch.models import TransMIL, build_mil_model
from acmil_tpu_torch.models.convert import from_jax_params
from scripts.import_torch_checkpoint import convert_transmil
from tests.conftest import make_synthetic_bags

D, L = 32, 32
ATOL, RTOL = 5e-4, 5e-4
BF16_ATOL, BF16_RTOL = 0.05, 0.1
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=name)


@functools.lru_cache(maxsize=None)
def _shapes(pad_mode):
    jm = JaxTransMIL(n_class=3, d_inner=L, pad_mode=pad_mode)
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, D)), jnp.ones((1, 64), bool))["params"]


def _pair(pad_mode="zero", dtype="float32", seed=0):
    """The flax head with every parameter from a seeded normal and the
    port's holding the same weights."""
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        _shapes(pad_mode))
    tm = TransMIL(3, D, L, dtype=td, pad_mode=pad_mode)
    tm.load_state_dict(from_jax_params(params, "transmil"))
    return JaxTransMIL(n_class=3, d_inner=L, dtype=jd, pad_mode=pad_mode), \
        params, tm.eval()


@functools.lru_cache(maxsize=None)
def _jit_apply(jm, return_attn=False):
    return jax.jit(functools.partial(jm.apply, deterministic=True,
                                     return_attn=return_attn))


def _bag(seed, n, valid, b=2):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for i, v in enumerate(valid):
        mask[i, :v] = True
    return feats, mask


# ---------------------------------------------------------------------------
# Registry, weights and converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_mode", ["zero", "wrap"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_registry_builds_with_the_jax_family(pad_mode, dtype):
    d = dict(arch="transmil", n_class=3, D_feat=D, D_inner=L, seed=1,
             transmil_pad_mode=pad_mode, compute_dtype=dtype)
    model, family = build_mil_model(Config.from_dict(d))
    jm, jfamily = jax_build_model(JaxConfig.from_dict(d))
    assert family == jfamily == "default"
    assert isinstance(model, TransMIL)
    assert model.pad_mode == jm.pad_mode == pad_mode
    assert model.dtype == DTYPES[dtype][1] and jm.dtype == DTYPES[dtype][0]


def test_convert_round_trip_gives_the_jax_tree():
    """The port's state_dict → ``convert_transmil`` → the flax tree that
    ``from_jax_params`` started from, exactly."""
    _, params, tm = _pair()
    got = convert_transmil({k: v.numpy() for k, v in tm.state_dict().items()})
    want_leaves, want_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)


def test_init_follows_the_jax_distributions():
    """The registry build at the camelyon_medical_ssl widths: every tensor
    has its JAX twin's zeros, ones and, where large enough to tell, spread
    (torch-default uniforms, N(0, 1) cls token)."""
    d = dict(arch="transmil", n_class=2, D_feat=384, D_inner=128, seed=3)
    jm, _ = jax_build_model(JaxConfig.from_dict(d))
    want = from_jax_params(_np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 384)),
        jnp.ones((1, 16), bool))["params"]), "transmil")
    got = build_mil_model(Config.from_dict(d))[0].state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not w.any() or (w == 1).all():
            assert torch.equal(g, w), k
        elif w.numel() >= 100:
            ratio = float(g.std() / w.std())
            assert 0.8 < ratio < 1.2, (k, ratio)


# ---------------------------------------------------------------------------
# The module against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_mode, n, valid", [
    ("zero", 300, (300, 170)),     # not a power of two: an 18x18 grid
    ("zero", 256, (200, 17)),      # a 16x16 grid of masked pad slots
    ("wrap", 200, (200, 200)),     # natural length: the reference's grid
    ("wrap", 256, (200, 37)),      # bucket-padded bags wrap their prefix
])
def test_module_matches_flax(pad_mode, n, valid):
    jm, params, tm = _pair(pad_mode, seed=1)
    feats, mask = _bag(2, n, valid)
    want, want_attn = _jit_apply(jm, True)({"params": params},
                                          jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got, attn = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                       return_attn=True)
        plain = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    _close(got, want, name="logits")
    assert torch.equal(plain, got)
    assert attn.shape == (2, n)
    for i, v in enumerate(valid):
        _close(attn[i, :v], np.asarray(want_attn)[i, :v], name="attn")


def test_module_without_a_mask_matches_flax():
    jm, params, tm = _pair(seed=2)
    feats, _ = _bag(3, 100, ())
    want = _jit_apply(jm)({"params": params}, jnp.asarray(feats), None)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats))
    _close(got, want)


def test_bf16_matches_jax_bf16_and_f32():
    """``compute_dtype: bfloat16`` against the JAX package's bf16 head, and
    against the f32 head on the same weights."""
    jm, params, tm = _pair(dtype="bfloat16", seed=3)
    feats, mask = _bag(4, 256, (200, 256))
    want = _jit_apply(jm)({"params": params}, jnp.asarray(feats),
                          jnp.asarray(mask))
    tm32 = TransMIL(3, D, L)
    tm32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask))
        f32 = tm32.eval()(torch.from_numpy(feats), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, want, BF16_ATOL, BF16_RTOL)
    _close(got, f32, BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("pad_mode", ["zero", "wrap"])
def test_masked_slots_are_inert_and_an_empty_bag_is_finite(pad_mode):
    """Garbage in the padded slots changes no logit (in wrap mode too: the
    wrap reads the valid prefix only), and an all-masked bag gives finite
    logits and gradients."""
    _, _, tm = _pair(pad_mode, seed=4)
    feats, mask = _bag(5, 256, (200, 0))
    garbage = feats.copy()
    garbage[~mask] = 37.0
    with torch.no_grad():
        a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
        b = tm(torch.from_numpy(garbage), torch.from_numpy(mask))
    _close(b[:1], a[:1], 1e-5, 1e-5)
    feats[~mask] = 0.0
    out = tm(torch.from_numpy(feats[1:]), torch.from_numpy(mask[1:]))
    assert torch.isfinite(out).all()
    out.sum().backward()
    for name, p in tm.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("pad_mode", ["zero", "wrap"])
def test_grads_match_jax(pad_mode):
    """Every gradient of a CE loss on the deterministic forward."""
    jm, params, tm = _pair(pad_mode, seed=5)
    feats, mask = _bag(6, 256, (230, 90))
    labels = np.array([1, 2])

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(feats),
                          jnp.asarray(mask), deterministic=True)
        return jax_ce(logits, jnp.asarray(labels))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = cross_entropy(tm(torch.from_numpy(feats), torch.from_numpy(mask)),
                         torch.from_numpy(labels))
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    want = from_jax_params(_np_tree(grads_j), "transmil")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for name in got:
        _close(got[name], want[name].numpy(), atol=ATOL * scale, rtol=RTOL,
               name=name)


def test_dropout_runs_only_in_training_with_the_generator():
    _, _, tm = _pair(seed=6)
    x = torch.from_numpy(_bag(7, 64, ())[0])
    plain = tm(x)
    tm.train()
    assert torch.equal(tm(x), plain)                         # deterministic
    draw = [tm(x, deterministic=False,
               generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], plain)


# ---------------------------------------------------------------------------
# The CLIs: Step3 training, predict, Step4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("transmil")
    slides = make_synthetic_bags(n_slides=10, d=D, seed=8, min_len=10,
                                 max_len=200)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:6], "val_names": names[6:8],
                   "test_names": names[8:]}, f)
    return d, slides


def _run_conf(d, tag, **kw):
    out = dict(dataset="camelyon", n_class=2, D_feat=D, D_inner=L,
               arch="transmil", lr=1e-3, train_epoch=1, min_bucket=256,
               seed=0, pretrain="tiny", data_dir=str(d),
               split_dir=str(d / "splits"), ckpt_dir=str(d / tag / "ckpt"),
               log_dir=str(d / tag / "log"))
    out.update(kw)
    return out


@pytest.mark.parametrize("pad_mode", ["zero", "wrap"])
def test_step3_generic_trains_and_predict_scores_as_jax(corpus, tmp_path,
                                                        pad_mode):
    """One epoch of ``cli/step3_generic.py --arch transmil --device cpu``,
    finite; ``cli/predict.py`` on its best checkpoint against the JAX eval
    step on the same weights (through ``convert_transmil``); Step4 refuses
    the head, as the JAX Step4 does (bare logits, no attention)."""
    d, slides = corpus
    tag = f"port_{pad_mode}"
    yml = d / f"{tag}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, tag,
                                            transmil_pad_mode=pad_mode)))
    step3_generic.main(["--config", str(yml), "--device", "cpu"])
    with open(d / tag / "log" / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train/loss"])

    ckpt_dir = str(d / tag / "ckpt")
    res = predict.main(["--config", str(yml), "--ckpt", ckpt_dir,
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert len(res["rows"]) == len(slides)
    ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
    jm, family = jax_build_model(JaxConfig.from_dict(
        _run_conf(d, tag, transmil_pad_mode=pad_mode)))
    jstep = jax_make_eval_step(jm, family)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert_transmil(
        {k: v.numpy() for k, v in ck["model"].items()}))
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                dtype=np.float16)
        _close(row[2:4], np.asarray(jstep(jparams, jbag))[0], name=row[0])

    model, _ = build_mil_model(Config.from_dict(_run_conf(d, tag)))
    model.load_state_dict(ck["model"])
    x = torch.randn(1, 40, D)
    with pytest.raises(ValueError, match="model emits no attention"):
        step4_heatmap.attention_probs(model, Bag(x, torch.ones(
            1, 40, dtype=torch.bool), None, None))
