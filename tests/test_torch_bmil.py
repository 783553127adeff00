"""The port's BMIL heads (acmil_tpu_torch/models/bmil.py: LinearVDO,
BMILVis as ``bmil_vis``/``bmil_enc``, BMILSpvis as ``bmil_spvis``) and
BMILFamily against the JAX package, on the same numpy inputs and the same
weights.

The deterministic path (eval: LinearVDO's mean, the attention at μ) is held
to the flax modules: outputs at valid positions within ATOL/RTOL (C3), the
family's loss (CE + 1e-8 · kl_model + 1e-6 · kl_data, with ``label``) and
every gradient within GRAD_ATOL/GRAD_RTOL, five AdamW steps. The stochastic
path draws its noise from a torch generator, which cannot repeat JAX's
draws, so it is held by its moments over R fixed draws: the sample mean and
variance of each sampled quantity against their closed forms, within
MOMENT_SIGMAS standard errors. The spvis canvas is held to the JAX package
on the CPU on a bag built so that many patches share a cell.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import make_train_step as jax_make_step
from acmil_tpu.engine.families import BMILFamily as JaxBMILFamily
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models.bmil import BMILSpvis as JaxSpvis
from acmil_tpu.models.bmil import BMILVis as JaxVis
from acmil_tpu.models.bmil import vdo_kl as jax_vdo_kl
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (create_train_state, get_family,
                                    make_eval_step, make_train_step)
from acmil_tpu_torch.engine.families import BMILFamily
from acmil_tpu_torch.models import BMILSpvis, BMILVis, build_mil_model
from acmil_tpu_torch.models.bmil import (LinearVDO, kl_model,
                                         scatter_winners, vdo_kl)
from acmil_tpu_torch.models.convert import from_jax_params
from scripts.import_torch_checkpoint import convert_bmil_vis

D, H, A, GRID = 32, 24, 16, 8
ATOL, RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-3
ARCHS = ["bmil_vis", "bmil_enc", "bmil_spvis"]
R = 4000                 # draws for the moment checks
MOMENT_SIGMAS = 5.0


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _modules(arch, n_class=3, droprate=0.0):
    if arch == "bmil_spvis":
        return (JaxSpvis(n_class=n_class, d_feat=D, d_hidden=H, d_attn=A,
                         grid=GRID, droprate=droprate),
                BMILSpvis(n_class, D, H, A, grid=GRID, droprate=droprate))
    kl = arch == "bmil_enc"
    return (JaxVis(n_class=n_class, d_feat=D, d_hidden=H, d_attn=A,
                   droprate=droprate, with_kl=kl),
            BMILVis(n_class, D, H, A, droprate=droprate, with_kl=kl))


@functools.lru_cache(maxsize=None)
def _shapes(arch, n_class, droprate):
    jm = _modules(arch, n_class, droprate)[0]
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, D)), jnp.ones((1, 8), bool),
                          coords=jnp.zeros((1, 8, 2), jnp.int32))["params"]


def _pair(arch, n_class=3, seed=0, droprate=0.0):
    jm, tm = _modules(arch, n_class, droprate)
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        _shapes(arch, n_class, droprate))
    tm.load_state_dict(from_jax_params(params, arch, droprate))
    return jm, params, tm.eval()


def _bag_arrays(seed, b=3, n=300, n_class=3, span=5000):
    """Bag 0 mostly valid, bag 1 with 10 valid rows, bag 2 all masked;
    coords in [0, span)."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    if b > 1:
        mask[1] = False
        mask[1, rs.choice(n, 10, replace=False)] = True
    if b > 2:
        mask[2] = False
    coords = rs.randint(0, span, (b, n, 2)).astype(np.int32)
    return feats, mask, coords, rs.randint(0, n_class, b)


def _bags(feats, mask, coords, labels):
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.asarray(coords),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.from_numpy(coords),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _jax_det(jm, params, jb, label=True):
    """The JAX family's deterministic outputs, the model KL merged."""
    out = jax.jit(functools.partial(jm.apply, deterministic=True,
                                    mutable=["kl"]))(
        {"params": params}, jb.feats, jb.mask, coords=jb.coords,
        label=jb.label if label else None)
    return JaxBMILFamily()._merge_kl(out)


def _port_det(tm, tb, label=True):
    return BMILFamily._with_kl_model(tm, tm(
        tb.feats, tb.mask, coords=tb.coords,
        label=tb.label if label else None, deterministic=True))


def _check_outputs(got, want, mask, name=""):
    _close(got["logits"].detach().numpy(), want["logits"], name=name + "logits")
    valid = np.broadcast_to(mask[:, None, :], got["attn"].shape)
    _close(got["attn"].detach().numpy()[valid],
           np.asarray(want["attn"])[valid], name=name + "attn")
    for k in ("kl_data", "kl_model"):
        _close(got[k].item(), float(want[k]), name=name + k)


def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("droprate", [0.25, 0.0])
def test_convert_bmil_vis_round_trip_gives_the_jax_tree(droprate):
    _, params, tm = _pair("bmil_vis", droprate=droprate)
    sd = tm.state_dict()
    assert f"attention_net.{3 if droprate else 2}.attention_a.0.weight" in sd
    got = convert_bmil_vis({k: v.numpy() for k, v in sd.items()})
    want_leaves, want_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_distributions(arch):
    """Registry builds at the serving width: zeros and constants (log α)
    exactly as JAX, spreads within 10% where a tensor is large enough."""
    d = dict(arch=arch, n_class=2, D_feat=384, D_inner=128, seed=3)
    jm, family = jax_build_model(JaxConfig.from_dict(d))
    init = jax.jit(functools.partial(jm.init, coords=jnp.zeros((1, 8, 2),
                                                               jnp.int32)))
    want = from_jax_params(_np_tree(init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 384)),
        jnp.ones((1, 8), bool))["params"]), arch, 0.25)
    tm, fam = build_mil_model(Config.from_dict(d))
    assert fam == family == "bmil"
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if float(w.std()) == 0.0:
            assert torch.equal(g, w), k
        elif w.numel() >= 1000:
            ratio = float(g.std() / w.std())
            assert 0.9 < ratio < 1.1, (k, ratio)


def test_vdo_kl_matches_jax():
    la = np.random.RandomState(0).randn(7, 5).astype(np.float32) * 3
    _close(vdo_kl(torch.from_numpy(la)).item(), float(jax_vdo_kl(la)))
    layer = LinearVDO(7, 5)
    with torch.no_grad():
        layer.log_alp.copy_(torch.from_numpy(la.T))
    _close(layer.kl().item(), float(jax_vdo_kl(la)))


# ---------------------------------------------------------------------------
# The deterministic path against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [True, False])
def test_module_matches_flax(arch, label):
    jm, params, tm = _pair(arch, seed=1)
    arrays = _bag_arrays(2)
    jb, tb = _bags(*arrays)
    with torch.no_grad():
        got = _port_det(tm, tb, label)
    _check_outputs(got, _jax_det(jm, params, jb, label), arrays[1])


def test_spvis_collisions_fill_each_cell_with_its_last_valid_patch():
    """Coords in [0, 20) on an 8x8 canvas: ~4 valid patches a cell. The
    JAX package on the CPU keeps the last duplicate, and so does the port's
    rule on every device (the valid patch with the highest index); the
    gradient reaches that patch alone in both."""
    jm, params, tm = _pair("bmil_spvis", seed=3)
    arrays = _bag_arrays(4, b=2, n=300, span=20)
    jb, tb = _bags(*arrays)
    with torch.no_grad():
        got = _port_det(tm, tb)
    _check_outputs(got, _jax_det(jm, params, jb), arrays[1])

    # the canvas itself, against JAX's scatter on the same cells
    rs = np.random.RandomState(5)
    cell = rs.randint(0, 10, (2, 40))
    cell[0, 5] = 12                             # no cell (a masked patch)
    vals = rs.randn(2, 40).astype(np.float32)
    want = jax.vmap(lambda cv, ix, vl: cv.at[ix].set(vl, mode="drop"))(
        jnp.zeros((2, 10)), jnp.asarray(cell), jnp.asarray(vals))
    win = scatter_winners(torch.from_numpy(cell), 10)
    canvas = torch.where(win >= 0, torch.gather(torch.from_numpy(vals), 1,
                                                win.clamp_min(0)),
                         torch.zeros(()))
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want))
    for b in range(2):
        for c in range(10):
            hits = np.flatnonzero(cell[b] == c)
            assert win[b, c] == (hits.max() if len(hits) else -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_slots_are_inert_and_an_empty_bag_is_finite(arch):
    """Garbage features and coords in the padded slots change no output;
    a stochastic training step on zero-padded bags, one of them with every
    slot masked, gives a finite loss and finite gradients (the second ε
    outside LinearVDO's variance)."""
    _, _, tm = _pair(arch, seed=6, droprate=0.25)
    feats, mask, coords, labels = _bag_arrays(7)
    rs = np.random.RandomState(8)
    g_feats, g_coords = feats.copy(), coords.copy()
    g_feats[~mask] = 1e3 * rs.randn(int((~mask).sum()), D)
    g_coords[~mask] = 10 ** 6
    with torch.no_grad():
        a = _port_det(tm, _bags(feats, mask, coords, labels)[1])
        b = _port_det(tm, _bags(g_feats, mask, g_coords, labels)[1])
    for k in ("logits", "attn", "kl_data"):
        _close(b[k].numpy(), a[k].numpy(), atol=1e-5, rtol=1e-5, name=k)
    feats[~mask] = 0.0
    tb = _bags(feats, mask, coords, labels)[1]
    fam = get_family("bmil")
    conf_d = fam.conf_dict(Config.from_dict(dict(arch=arch, n_class=3)))
    tm.train()
    out = fam.train_outputs(tm, tb, conf_d,
                            generator=torch.Generator().manual_seed(0))
    loss, _ = fam.loss(out, tb, tb.mask.any(dim=1), conf_d)
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


# ---------------------------------------------------------------------------
# Training: the family's loss and gradients, five AdamW steps
# ---------------------------------------------------------------------------

class _JaxDeterministic(JaxBMILFamily):
    """The JAX family with its training forward deterministic (the noise
    of the two packages cannot be the same draws)."""

    def train_outputs(self, apply_fn, params, bag, rngs, conf_d):
        return self._merge_kl(apply_fn(
            {"params": params}, bag.feats, bag.mask, coords=bag.coords,
            label=bag.label, deterministic=True, mutable=["kl"]))


class _PortDeterministic(BMILFamily):
    def train_outputs(self, model, bag, conf_d, stkim_u=None, generator=None):
        return _port_det(model, bag)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_loss_and_grads_match_jax(arch):
    """The family's loss (CE + 1e-8 kl_model + 1e-6 kl_data) and every
    gradient, log α included, on the deterministic path with ``label``."""
    jm, params, tm = _pair(arch, seed=11)
    jb, tb = _bags(*_bag_arrays(12))
    jfam, fam = _JaxDeterministic(), _PortDeterministic()
    conf = dict(arch=arch, n_class=3)
    jconf_d = jfam.conf_dict(JaxConfig.from_dict(conf))
    conf_d = fam.conf_dict(Config.from_dict(conf))

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb, {}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)

    (loss_j, parts_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm.train()
    loss, parts = fam.loss(fam.train_outputs(tm, tb, conf_d), tb,
                           tb.mask.any(dim=1), conf_d)
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    for k in ("ce_loss", "kl_model", "kl_data"):
        _close(parts[k].item(), float(parts_j[k]), name=k)
    assert parts["kl_model"].item() != 0.0
    want = from_jax_params(_np_tree(grads_j), arch, 0.0)
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_adamw_steps_match_jax(arch):
    d = dict(arch=arch, n_class=3, D_feat=D, lr=1e-3, train_epoch=2, seed=0)
    jconf, conf = JaxConfig.from_dict(d), Config.from_dict(d)
    jm, _, tm = _pair(arch, seed=13)
    bags = [_bags(*_bag_arrays(30 + i, b=1, n=100)) for i in range(3)]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 3)
    p0 = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    tm.load_state_dict(p0)
    state = create_train_state(tm, conf, 3)
    jstep = jax_make_step(jm, jconf, _JaxDeterministic())
    step = make_train_step(tm, conf, _PortDeterministic())
    for i in range(5):
        jb, tb = bags[i % 3]
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb)
        for k in ("loss", "kl_model", "kl_data"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    want = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    for name, p in tm.named_parameters():
        d_want = (want[name] - p0[name]).numpy()
        d_got = p.detach().numpy() - p0[name].numpy()
        # an element whose gradient is within rounding of 0 steps by
        # AdamW-normalised noise: at most 1% miss the tight bound, none
        # by more than 2% of the largest five-step move (5 lr)
        ulps = 5 * np.spacing(np.abs(p0[name].numpy()).max())
        tol = 1e-4 * np.abs(d_want).max() + ulps + 1e-3 * np.abs(d_want)
        miss = np.abs(d_got - d_want) > tol
        assert miss.mean() <= 0.01, (name, int(miss.sum()), miss.size)
        _close(d_got, d_want, atol=0.02 * 5 * conf.lr, rtol=0, name=name)


def test_family_passes_coords_and_label_as_jax():
    """Training passes coords and label, eval coords only: spvis's eval
    output moves with the coords, and carries no data KL."""
    _, _, tm = _pair("bmil_spvis", seed=16)
    feats, mask, coords, labels = _bag_arrays(17)
    tb = _bags(feats, mask, coords, labels)[1]
    ev = make_eval_step(tm, "bmil")
    fam = get_family("bmil")
    out = fam.eval_outputs(tm, tb)
    assert out["kl_data"].item() == 0.0
    _close(out["kl_model"].item(), kl_model(tm).item())
    moved = _bags(feats, mask, coords[:, ::-1].copy(), labels)[1]
    assert not torch.allclose(ev(tb), ev(moved))


# ---------------------------------------------------------------------------
# The stochastic path: moments over R fixed draws
# ---------------------------------------------------------------------------

def _moments_agree(samples, mean, var, name):
    """Sample mean within MOMENT_SIGMAS standard errors of ``mean``; sample
    variance within MOMENT_SIGMAS · sqrt(2 / R) of ``var`` (relative)."""
    r = samples.shape[0]
    m, v = samples.mean(0), samples.var(0, unbiased=True)
    assert ((m - mean).abs() <= MOMENT_SIGMAS * (var / r).sqrt()).all(), name
    assert ((v / var - 1).abs() <= MOMENT_SIGMAS * (2 / r) ** 0.5).all(), name


def test_linear_vdo_samples_its_closed_form():
    layer = LinearVDO(6, 4, ard_init=-1.0,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        draws = torch.stack([layer(x, True, gen) for _ in range(R)])
        mean = layer(x)
        var = (x * x) @ (layer.log_alp.exp() * layer.weight ** 2 + 1e-8).t() \
            + 1e-8
    _moments_agree(draws, mean, var, "LinearVDO")
    assert torch.equal(layer(x, True, noise=torch.zeros(3, 4)), mean)


def test_vis_attention_samples_its_gaussian():
    """BMILVis's attention is the sigmoid of N(μ, exp(log σ²)) per patch:
    its logit over R draws (the classifier's noise held at 0) has μ for
    mean and exp(log σ²) for variance; μ is the eval attention's logit."""
    _, _, tm = _pair("bmil_vis", seed=18)
    feats, mask, _, _ = _bag_arrays(19, b=1, n=40)
    mask[:] = True
    x = torch.from_numpy(feats).expand(R, -1, -1)
    with torch.no_grad():
        mu = torch.logit(tm(x[:1])["attn"][0, 0].double())
        ag = tm.attention_net[-1]
        h = torch.relu(tm.attention_net[0](x[:1]))
        logvar = ag.attention_c(torch.tanh(ag.attention_a[0](h))
                                * torch.sigmoid(ag.attention_b[0](h)))[0, :, 1]
        tm.train()
        out = tm(x, deterministic=False,
                 generator=torch.Generator().manual_seed(4),
                 noise={"classifiers": torch.zeros(R, 3)})
    g = torch.logit(out["attn"][:, 0].double())
    _moments_agree(g, mu, logvar.exp().double(), "attention logit")


def test_spvis_classifier_samples_its_closed_form():
    """With every other draw held at 0, spvis's logits over R draws have
    the eval logits for mean and LinearVDO's variance of the bag feature."""
    _, _, tm = _pair("bmil_spvis", seed=20)
    feats, mask, coords, _ = _bag_arrays(21, b=1, n=60)
    x, m, c = (torch.from_numpy(a).expand(R, *a.shape[1:])
               for a in (feats, mask, coords))
    zeros = {"attention_a": torch.zeros(R, 60, A),
             "attention_b": torch.zeros(R, 60, A),
             "attention_c": torch.zeros(R, 60, 2),
             "attn": torch.zeros(R, GRID, GRID)}
    with torch.no_grad():
        det = tm(x[:1], m[:1], coords=c[:1])
        A_ = det["attn"][:, 0]
        h = torch.relu(tm.fc(x[:1]))
        M = torch.einsum("bn,bnd->bd", A_, h) / A_.sum(1, keepdim=True)
        cls = tm.classifiers
        var = (M * M) @ (cls.log_alp.exp() * cls.weight ** 2 + 1e-8).t() + 1e-8
        tm.train()
        out = tm(x, m, coords=c, deterministic=False,
                 generator=torch.Generator().manual_seed(5), noise=zeros)
    _moments_agree(out["logits"].double(), det["logits"][0].double(),
                   var[0].double(), "spvis logits")


@pytest.mark.parametrize("arch", ["bmil_vis", "bmil_spvis"])
def test_step4_scores_the_attention_as_the_jax_formula(arch):
    """``cli/step4_heatmap.py``'s scores on a BMIL head: the output dict's
    ``attn``, then the masked softmax, as the JAX Step4 computes them, with
    the bag's coords given to the head as its family's eval gives them."""
    from acmil_tpu.ops.masked import masked_softmax as jax_masked_softmax
    from acmil_tpu_torch.cli import step4_heatmap

    jm, params, tm = _pair(arch, seed=22)
    feats, mask, coords, labels = _bag_arrays(23, b=2)
    jb, tb = _bags(feats, mask, coords, labels)
    got = step4_heatmap.attention_probs(tm, tb, "bmil")
    a = _jax_det(jm, params, jb, label=False)["attn"]
    want = jax_masked_softmax(a, jb.mask[:, None, :]).mean(1)
    _close(got.numpy()[mask], np.asarray(want)[mask])
