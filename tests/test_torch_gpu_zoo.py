"""The rest of the generic zoo on the card against the CPU: every head this
slice registers (meanmil, maxmil, lbmil, attmil, attmil_gated, ilra, ips,
ibmil in both phases, bmil_vis, bmil_enc, bmil_spvis) at the serving widths
(D_feat 384, D_inner 128), its eval forward and the gradients of its
deterministic loss on ``cuda`` against the same weights on the CPU, one
stochastic training step on the card, and k-means and the spvis canvas on
the card against the CPU. The file imports no JAX or flax, so it runs on
the card's machine; its tests carry the ``gpu`` marker and skip without a
card. tests/test_torch_zoo.py, test_torch_bmil.py and test_torch_ibmil.py
hold the CPU path against the JAX package.
"""

import copy

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (create_train_state, get_family,
                                    make_train_step)
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.models.bmil import scatter_winners
from acmil_tpu_torch.ops import kmeans

ARCHS = ["meanmil", "maxmil", "lbmil", "attmil", "attmil_gated", "ilra",
         "ips", "ibmil", "ibmil_p2", "bmil_vis", "bmil_enc", "bmil_spvis"]
# f32 on both devices with TF32 off: the sums differ in order only; each
# gradient is held to GRAD_REL of its own largest element. The elements
# that _shift_invariant names have a gradient of 0 in exact arithmetic, so
# both devices give rounding noise there: they are held to GRAD_FLOOR of
# the model's largest gradient instead
OUT_REL, GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3, 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the zoo's card path needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _shift_invariant(name, shape) -> torch.Tensor:
    """The elements of a bias that shifts every logit of one softmax
    alike: the attention output's bias (attMIL, IPS, IBMIL), IBMIL's
    phase-2 key bias ``W_k``, and ILRA's key biases (``fc_k`` and the key
    third of each in-projection)."""
    m = torch.zeros(shape, dtype=torch.bool)
    if name in ("attention.2.bias", "attention.attention_weights.bias",
                "W_k.bias") or name.endswith("fc_k.bias"):
        m[...] = True
    if name.endswith("in_proj_bias"):
        m[shape[0] // 3:2 * shape[0] // 3] = True
    return m


def _rel_to_max(got, want) -> float:
    diff = float((got.detach().cpu().double() - want.detach().double()
                  ).abs().max())
    return diff / max(float(want.detach().double().abs().max()), 1e-30)


def _model(arch, tmp_path):
    d = dict(arch=arch, n_class=2, D_feat=384, D_inner=128, seed=5)
    if arch == "ibmil_p2":
        path = tmp_path / "protos.npy"
        np.save(path, np.random.RandomState(0).randn(8, 128).astype(np.float32))
        d.update(arch="ibmil", c_path=[str(path)])
    conf = Config.from_dict(d)
    model, family = build_mil_model(conf)
    return model, family, conf


def _bag(device, b=2, n=4096, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, n), bool)
    mask[0, :3000] = True
    mask[1, :700] = True
    feats = rs.randn(b, n, 384).astype(np.float16)
    feats[~mask] = 0
    coords = (rs.randint(0, 60, (b, n, 2)) * 256).astype(np.int32)
    return Bag(torch.from_numpy(feats), torch.from_numpy(mask),
               torch.from_numpy(coords),
               torch.arange(b, dtype=torch.int64) % 2).to(device)


def _det_loss(model, family, bag):
    """The family's loss on the deterministic forward (no dropout, no
    noise), the labels in."""
    fam = get_family(family)
    conf_d = {"n_class": 2, "n_token": 1, "w_loss": 0.7}
    if family == "bmil":
        out = fam._with_kl_model(model, model(
            bag.feats, bag.mask, coords=bag.coords, label=bag.label,
            deterministic=True))
    else:
        out = model(bag.feats, bag.mask, deterministic=True)
    return fam.loss(out, bag, bag.mask.any(dim=1), conf_d)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_head_on_card_matches_cpu(cuda_device, tmp_path, arch):
    cpu, family, conf = _model(arch, tmp_path)
    card = copy.deepcopy(cpu).to(cuda_device)
    fam = get_family(family)
    bag_cpu, bag_card = _bag("cpu"), _bag(cuda_device)
    with torch.no_grad():
        want = fam.probs(fam.eval_outputs(cpu.eval(), bag_cpu))
        got = fam.probs(fam.eval_outputs(card.eval(), bag_card))
    assert _rel_to_max(got, want) <= OUT_REL
    for m, bag in ((cpu, bag_cpu), (card, bag_card)):
        m.train()
        _det_loss(m, family, bag).backward()
    floor = GRAD_FLOOR * max(float(p.grad.abs().max())
                             for p in cpu.parameters() if p.grad is not None)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        diff = (q.grad.cpu() - p.grad).abs()
        noise = _shift_invariant(name, p.shape)
        if noise.any():
            assert float(diff[noise].max()) <= floor, name
        if not noise.all():
            assert float(diff[~noise].max()) <= GRAD_REL * float(
                p.grad[~noise].abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_training_step_on_card(cuda_device, tmp_path, arch):
    """One step of the trainer on the card, dropout and noise drawn there:
    a finite loss, and every parameter moved and finite."""
    model, family, conf = _model(arch, tmp_path)
    model.to(cuda_device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, conf, 1)
    aux = make_train_step(model, conf, family)(state, _bag(cuda_device))
    assert torch.isfinite(aux["loss"])
    for n, p in model.named_parameters():
        assert torch.isfinite(p).all(), n
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())


@pytest.mark.gpu
def test_kmeans_on_card_matches_cpu(cuda_device):
    rs = np.random.RandomState(1)
    centers = rs.randn(8, 128).astype(np.float32) * 6
    x = np.concatenate([c + 0.2 * rs.randn(300, 128).astype(np.float32)
                        for c in centers])
    got_a, got_c = kmeans.kmeans(torch.from_numpy(x).to(cuda_device), 8)
    want_a, want_c = kmeans.kmeans(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, atol=1e-4, rtol=0)
    init = torch.from_numpy(x[::300].copy())
    gc, ga = kmeans._lloyd(torch.from_numpy(x).to(cuda_device),
                           init.to(cuda_device), 8, 20)
    wc, wa = kmeans._lloyd(torch.from_numpy(x), init, 8, 20)
    assert torch.equal(ga.cpu(), wa)
    assert _rel_to_max(gc, wc) <= 1e-5


@pytest.mark.gpu
def test_spvis_canvas_on_card_matches_cpu(cuda_device):
    """Many patches a cell: the card's winners are the CPU's (the highest
    valid index), launch after launch."""
    cell = torch.from_numpy(np.random.RandomState(2).randint(
        0, 70, (3, 50000))).long()
    cell[:, ::7] = 64 * 64                      # masked patches: no cell
    want = scatter_winners(cell, 64 * 64)
    for _ in range(2):
        assert torch.equal(scatter_winners(cell.to(cuda_device),
                                           64 * 64).cpu(), want)
