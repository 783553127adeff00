"""TransMIL and MHIM on the card against the CPU: each head's eval forward
at the serving widths (TransMIL at camelyon_medical_ssl, D_feat 384 and
D_inner 128; MHIM and 'pure' at the MHIM script's mlp_dim 512), the
gradients of a loss on the deterministic forward, and one MHIM training
step with the EMA teacher, on ``cuda`` against the same weights on the CPU.
The file imports no JAX or flax, so it runs on the card's machine; its tests
carry the ``gpu`` marker and skip without a card. tests/test_torch_nystrom.py,
test_torch_transmil.py and test_torch_mhim.py hold the CPU path against the
JAX package.

Both devices run float32 with TF32 off, so they differ in the order of sums
only; the Newton–Schulz inverse amplifies that, so outputs and gradients
are held to REL of their largest element (the CPU tests' Nystrom tolerance,
5e-4, as a share of the largest element).
"""

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import create_train_state, make_train_step
from acmil_tpu_torch.engine.losses import cross_entropy
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.ops.nystrom import nystrom_attention

REL = 5e-4
HEADS = [("transmil", {}), ("transmil", {"transmil_pad_mode": "wrap"}),
         ("mhim", {}), ("mhim", {"baseline": "attn"}), ("pure", {}),
         ("mhim", {"pos": "peg"}), ("mhim", {"pos": "sincos"})]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the TransMIL/MHIM card path needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_to_max(got, want) -> float:
    diff = float((got.detach().cpu().double() - want.detach().double()
                  ).abs().max())
    return diff / max(float(want.detach().double().abs().max()), 1e-30)


def _conf(arch, **keys):
    d = dict(arch=arch, n_class=2, D_feat=384, D_inner=128, seed=5)
    d.update(keys)
    return Config.from_dict(d)


def _bag(device, b=2, n=4096, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, n), bool)
    mask[0, :3000] = True
    mask[1, :n] = True
    feats = rs.randn(b, n, 384).astype(np.float32) * mask[..., None]
    return Bag(torch.from_numpy(feats).to(device),
               torch.from_numpy(mask).to(device), None,
               torch.tensor([0, 1], device=device))


def _logits(out):
    return out["logits"] if isinstance(out, dict) else out


@pytest.mark.gpu
@pytest.mark.parametrize("arch, keys", HEADS)
def test_eval_forward_and_grads_on_the_card_match_the_cpu(cuda_device, arch,
                                                          keys):
    model, _ = build_mil_model(_conf(arch, **keys))
    card, _ = build_mil_model(_conf(arch, **keys))
    card.load_state_dict(model.state_dict())
    card.to(cuda_device)
    outs = []
    for m, dev in ((model, "cpu"), (card, cuda_device)):
        bag = _bag(dev)
        m.eval()
        logits = _logits(m(bag.feats, bag.mask))
        cross_entropy(logits, bag.label).backward()
        outs.append((logits, {n: p.grad for n, p in m.named_parameters()}))
    (cpu_l, cpu_g), (gpu_l, gpu_g) = outs
    assert _rel_to_max(gpu_l, cpu_l) <= REL
    for name, g in cpu_g.items():
        assert _rel_to_max(gpu_g[name], g) <= REL, name


@pytest.mark.gpu
def test_transmil_bf16_on_the_card_tracks_f32(cuda_device):
    model, _ = build_mil_model(_conf("transmil", compute_dtype="bfloat16"))
    f32, _ = build_mil_model(_conf("transmil"))
    f32.load_state_dict(model.state_dict())
    bag = _bag(cuda_device)
    with torch.no_grad():
        a = model.to(cuda_device).eval()(bag.feats, bag.mask)
        b = f32.to(cuda_device).eval()(bag.feats, bag.mask)
    assert a.dtype == torch.float32
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0.1,
                               atol=0.05)


@pytest.mark.gpu
def test_nystrom_core_at_65536_rows_matches_the_cpu(cuda_device):
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(1, 8, 65792, 64).astype(np.float32)
                                * s) for s in (0.125, 1.0, 1.0))
    mask = torch.zeros(1, 65792, dtype=torch.bool)
    mask[0, 256:50257] = True
    want, rows = nystrom_attention(q, k, v, mask, 256, return_attn_rows=1,
                                   attn_row_offset=256)
    got, grows = nystrom_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), mask.to(cuda_device),
                                   256, return_attn_rows=1,
                                   attn_row_offset=256)
    valid = mask[0]
    assert _rel_to_max(got[..., valid, :], want[..., valid, :]) <= REL
    assert _rel_to_max(grows, rows) <= REL


@pytest.mark.gpu
def test_mhim_step_with_the_ema_on_the_card_matches_the_cpu(cuda_device):
    """Two steps of the mhim family on the deterministic masking path
    (DAttention, dropout 0, low- and high-attention masking with hr 1),
    from the same weights: the first step's gradients, both losses, then
    the parameters and the EMA teacher."""
    conf = _conf("mhim", baseline="attn", dropout=0.0, mask_ratio_l=0.2,
                 mask_ratio_h=0.1, mm=0.9, mm_sche=True, mrh_sche=True,
                 train_epoch=2, steps_per_epoch=2, lr=1e-3)
    model, family = build_mil_model(conf)
    card, _ = build_mil_model(conf)
    card.load_state_dict(model.state_dict())
    card.to(cuda_device)
    res = []
    for m, dev in ((model, "cpu"), (card, cuda_device)):
        state = create_train_state(m, conf, 2, family=family)
        step = make_train_step(m, conf, family)
        losses = [float(step(state, _bag(dev, seed=2))["loss"])]
        grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        losses.append(float(step(state, _bag(dev, seed=3))["loss"]))
        res.append((losses, grads, dict(m.named_parameters()),
                    dict(state.teacher.named_parameters())))
    (cpu_loss, cpu_g, cpu_p, cpu_t), (gpu_loss, gpu_g, gpu_p, gpu_t) = res
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-4)
    for name in cpu_p:
        assert _rel_to_max(gpu_g[name], cpu_g[name]) <= REL, name
        # Adam moves each element by about lr whatever its gradient, so the
        # parameters are held to a share of that move. An element whose
        # gradient plus the coupled decay is within rounding of 0 (eps 1e-8)
        # steps by the devices' rounding: as in tests/test_torch_zoo.py, at
        # most 1% of the elements may miss, each by at most the two steps'
        # bound, 2 lr (the second step's gradients then differ there too)
        for got, want in ((gpu_p[name], cpu_p[name]),
                          (gpu_t[name], cpu_t[name])):
            diff = (got.detach().cpu() - want.detach()).abs()
            assert float((diff > 0.05 * conf.lr).float().mean()) <= 0.01, name
            assert float(diff.max()) <= 2 * conf.lr, name


@pytest.mark.gpu
@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_stochastic_mhim_step_on_the_card_is_finite(cuda_device, baseline):
    """The script's recipe at mlp_dim 512: dropout 0.25, random high subset
    (hr 0.5); two steps with the card's generator, finite, and the teacher
    moves off the student's start."""
    conf = _conf("mhim", baseline=baseline, mask_ratio_h=0.1,
                 mask_ratio_hr=0.5, mm=0.9, mm_sche=True, mrh_sche=True,
                 train_epoch=1, steps_per_epoch=2)
    model, family = build_mil_model(conf)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.to(cuda_device)
    state = create_train_state(model, conf, 2, family=family)
    step = make_train_step(model, conf, family)
    for s in (4, 5):
        aux = step(state, _bag(cuda_device, seed=s))
        assert all(torch.isfinite(v) for v in aux.values())
    moved = [not torch.equal(p.detach().cpu(), start[n])
             for n, p in state.teacher.named_parameters()]
    assert all(moved)
