"""The port's library-only leftovers against their JAX counterparts on the
same numpy inputs: ``utils/augment.py``, ``utils/profiling.py``,
``engine/schedules.py::step_schedule``,
``engine/losses.py::binary_cross_entropy_with_logits``,
``config.py::add_config_argument``/``load_config``, BMIL's ``Conv2dVDO``,
attMIL's ``ResnetE2EMIL`` and ``cli/make_splits.py``."""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu import config as jax_config
from acmil_tpu.data import write_feature_h5
from acmil_tpu.engine import losses as jax_losses
from acmil_tpu.engine import schedules as jax_schedules
from acmil_tpu.models import attmil as jax_attmil
from acmil_tpu.models import bmil as jax_bmil
from acmil_tpu.utils import augment as jax_augment
from acmil_tpu_torch import config
from acmil_tpu_torch.cli import make_splits
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.engine import losses, schedules
from acmil_tpu_torch.models.attmil import ResnetE2EMIL
from acmil_tpu_torch.models.bmil import Conv2dVDO, kl_model
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.utils import augment, profiling
from tests.conftest import make_synthetic_bags
from tests.test_torch_resnet import FEAT_ATOL, FEAT_RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Conv2dVDO
# ---------------------------------------------------------------------------

def _vdo_case(seed=0, cin=5, features=4):
    jm = jax_bmil.Conv2dVDO(features=features, kernel=3, ard_init=-1.5)
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 6, 7, cin).astype(np.float32)
    x[:, :2, :2] = 0.0                                  # all-zero windows
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # spread log alpha so the KL's terms differ
    la = np.asarray(v["params"]["log_alp"]) + rs.randn(
        *v["params"]["log_alp"].shape).astype(np.float32)
    params = {"kernel": np.asarray(v["params"]["kernel"]), "log_alp": la}
    tm = Conv2dVDO(cin, features, 3, ard_init=-1.5)
    tm.load_state_dict(from_jax_params(params, "conv2d_vdo"))
    return jm, params, tm, x


def test_conv2d_vdo_mean_path_and_kl_match_jax():
    """The mean conv bit for bit; the KL, a sum over 45 rows of means, to
    1e-6 relative: XLA sums the rows in another order."""
    jm, params, tm, x = _vdo_case()
    want, state = jm.apply({"params": params}, jnp.asarray(x),
                           mutable=["kl"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        kl = tm.kl()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(kl.numpy(), np.asarray(state["kl"]["vdo"]),
                               rtol=1e-6, atol=0)
    # the port's BMIL sums it with its LinearVDO layers
    holder = torch.nn.Sequential(tm)
    assert torch.equal(kl_model(holder), kl)


def test_conv2d_vdo_sampled_path_matches_jax_with_its_draws(monkeypatch):
    jm, params, tm, x = _vdo_case(seed=1)
    drawn = []
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: drawn.append(
        real(*a, **k)) or drawn[-1])
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(3)},
                    mutable=["kl"])[0]
    assert len(drawn) == 1
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, deterministic=False,
             noise=torch.from_numpy(np.array(drawn[0])))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    # the epsilon outside the sqrt keeps all-zero windows' gradient finite
    got.sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert torch.isfinite(tm.log_alp.grad).all()


# ---------------------------------------------------------------------------
# ResnetE2EMIL
# ---------------------------------------------------------------------------

def test_resnet_e2e_mil_matches_flax():
    jm = jax_attmil.ResnetE2EMIL(n_class=2)
    rs = np.random.RandomState(4)
    patches = rs.rand(2, 3, 32, 32, 3).astype(np.float32)
    mask = np.array([[True, True, False], [True, False, False]])
    v = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 2, 32, 32, 3)))

    def draw(path, a):
        # batch-norm scales, biases and statistics drawn at random, so the
        # frozen norms do work (tests/test_torch_resnet.py's rule)
        name = str(path[-1])
        if "scale" in name:
            return (1 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + np.abs(rs.randn(*a.shape))).astype(np.float32)
        return np.asarray(a, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, v)
    want = np.asarray(jax.jit(lambda v, p, m: jm.apply(v, p, m))(
        v, jnp.asarray(patches), jnp.asarray(mask)))
    tm = ResnetE2EMIL(n_class=2).eval()
    tm.load_state_dict(from_jax_params(v["params"], "resnet_e2e",
                                       batch_stats=v["batch_stats"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(patches), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_RTOL)
    with pytest.raises(ValueError, match="batch_stats"):
        from_jax_params(v["params"], "resnet_e2e")


def test_resnet_e2e_mil_trains_with_frozen_norms():
    tm = ResnetE2EMIL(n_class=3, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tm.named_buffers()}
    patches = torch.rand(1, 2, 32, 32, 3)
    out = tm.train()(patches, torch.ones(1, 2, dtype=torch.bool),
                     deterministic=False,
                     generator=torch.Generator().manual_seed(1))
    out.sum().backward()
    assert out.shape == (1, 3) and tm.fc1.weight.grad is not None
    assert tm.resnet.bn1.weight.grad is not None
    for k, v in tm.named_buffers():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# Schedules, losses, config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("milestones, gamma", [((0.5, 0.75), 0.1),
                                               ((0.3,), 0.5)])
def test_step_schedule_matches_jax(milestones, gamma):
    want = jax_schedules.step_schedule(3e-4, 10, 7, milestones, gamma)
    got = schedules.step_schedule(3e-4, 10, 7, milestones, gamma)
    for step in range(0, 75):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=0, err_msg=str(step))


@pytest.mark.parametrize("with_valid", [False, True])
def test_binary_cross_entropy_with_logits_matches_jax(with_valid):
    rs = np.random.RandomState(6)
    logits = (rs.randn(4, 3) * 8).astype(np.float32)
    targets = (rs.rand(4, 3) < 0.5).astype(np.float32)
    valid = np.array([True, False, True, True]) if with_valid else None
    want = jax_losses.binary_cross_entropy_with_logits(
        jnp.asarray(logits), jnp.asarray(targets),
        None if valid is None else jnp.asarray(valid))
    got = losses.binary_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("argv", [[], ["--lr", "0.003", "--arch", "mha"]])
def test_load_config_matches_jax(argv):
    yml = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")

    def parse(add):
        p = argparse.ArgumentParser()
        add(p)
        p.add_argument("--lr", type=float, default=None)
        p.add_argument("--arch", type=str, default=None)
        return p.parse_args(["--config", yml, *argv])

    want = jax_config.load_config(
        parse(jax_config.add_config_argument)).to_dict()
    got = config.load_config(parse(config.add_config_argument)).to_dict()
    want.pop("scan_epoch")                  # an extra key in the port
    assert got == want


# ---------------------------------------------------------------------------
# Augmentations and split helpers
# ---------------------------------------------------------------------------

def _columns(out):
    return out[0, :, 0].long().tolist()


def _whole_groups(got, p, group):
    """``got`` is JAX's chunks of ``0..p-1`` (ids padded to a multiple of
    ``group`` and cut into ``group`` rows, pads dropped) in some order."""
    assert sorted(got) == list(range(p))
    if not 0 < group < p:
        return
    pad = (-p) % group
    rows = np.concatenate([np.arange(p), -np.ones(pad, int)]
                          ).reshape(group, -1)
    chunks = [tuple(int(i) for i in r[r >= 0]) for r in rows]
    seq, i = [], 0
    while i < p:
        c = next(c for c in chunks if c and c[0] == got[i])
        assert tuple(got[i:i + len(c)]) == c
        seq.append(c)
        i += len(c)
    assert sorted(seq) == sorted(c for c in chunks if c)


@pytest.mark.parametrize("p, group", [(23, 5), (20, 4), (9, 0), (9, 9)])
def test_group_shuffle_permutes_whole_groups_as_jax(p, group):
    x = torch.arange(p, dtype=torch.float32)[None, :, None].repeat(2, 1, 3)
    got = augment.group_shuffle(torch.Generator().manual_seed(0), x, group)
    _whole_groups(_columns(got), p, group)
    assert torch.equal(got[0], got[1])              # one order for the batch
    want = jax_augment.group_shuffle(jax.random.PRNGKey(0),
                                     jnp.asarray(x.numpy()), group)
    _whole_groups(np.asarray(want)[0, :, 0].astype(int).tolist(), p, group)


@pytest.mark.parametrize("p, group", [(23, 2), (16, 4), (10, 3), (10, 0)])
def test_patch_shuffle_matches_jax_on_the_same_block_order(p, group):
    x = np.arange(p, dtype=np.float32)[None, :, None].repeat(2, 0)
    gen = torch.Generator().manual_seed(1)
    got, g_idx = augment.patch_shuffle(gen, torch.from_numpy(x), group,
                                       return_g_idx=True)
    assert sorted(_columns(got)) == list(range(p))
    if g_idx is None:
        return
    assert sorted(g_idx.tolist()) == list(range(group ** 2))
    want = jax_augment.patch_shuffle(jax.random.PRNGKey(0), jnp.asarray(x),
                                     group, g_idx=jnp.asarray(g_idx.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_numpy_helpers_match_jax():
    rs = np.random.RandomState(7)
    labels = (rs.rand(40) < 0.4).astype(np.int64)
    scores = rs.rand(40) + 0.3 * labels
    assert augment.optimal_threshold(labels, scores) == \
        jax_augment.optimal_threshold(labels, scores)
    assert augment.five_scores(labels, scores) == \
        jax_augment.five_scores(labels, scores)
    items = [f"s{i}" for i in range(23)]
    for kw in (dict(labels=labels[:23]), dict(label_balance=False),
               dict(shuffle=False, labels=labels[:23])):
        assert augment.data_split(items, 0.3, seed=2, **kw) == \
            jax_augment.data_split(items, 0.3, seed=2, **kw)
    assert augment.k_fold_splits(items, 4, seed=3) == \
        jax_augment.k_fold_splits(items, 4, seed=3)


# ---------------------------------------------------------------------------
# Profiling and make_splits
# ---------------------------------------------------------------------------

def test_profile_trace_and_step_timer_on_the_cpu(tmp_path):
    with profiling.profile_trace(None) as none:
        assert none is None
    with profiling.profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(n.endswith(".json") for n in os.listdir(tmp_path))
    assert profiling.device_events(prof) == []         # no card traced
    timer = profiling.StepTimer()
    assert timer.tick() >= 0.0 and timer.steps == 1


@pytest.mark.parametrize("fmt", ["pt", "h5"])
def test_make_splits_writes_the_jax_scripts_jsons(tmp_path, fmt, monkeypatch):
    slides = make_synthetic_bags(n_slides=17, d=4, seed=8, min_len=3,
                                 max_len=6)
    h5 = str(tmp_path / "f.h5")
    write_feature_h5(h5, slides)
    feats = h5
    if fmt == "pt":
        feats = str(tmp_path / "f.pt")
        write_feature_pt(feats, slides)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_splits as jax_script
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["make_splits.py", "--h5", h5,
                                      "--out_dir", str(tmp_path / "want"),
                                      "--seeds", "1", "4"])
    jax_script.main()
    flag = "--features" if fmt == "pt" else "--h5"
    paths = make_splits.main([flag, feats, "--out_dir",
                              str(tmp_path / "got"), "--seeds", "1", "4"])
    assert [os.path.basename(p) for p in paths] == ["split_1.json",
                                                    "split_4.json"]
    for p in paths:
        with open(p) as g, open(tmp_path / "want" / os.path.basename(p)) as w:
            assert g.read() == w.read()
        with open(p) as g:
            split = json.load(g)
        assert split["test_names"] and all("test" in n for n in
                                           split["test_names"])
