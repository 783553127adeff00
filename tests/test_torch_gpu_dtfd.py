"""DTFD, SAM and the ResNet trunks on the card: DTFD's route through
kernels B1 and B2 (``models/fast.py::dtfd_apply_fused``, an identity first
layer over the gathered ``mid``) against its plain forward at the
camelyon_medical_ssl and natural_supervised widths, with its launches
counted; the eval grouping's uniforms on the card against the CPU's; one
SAM step of ACMIL_GA on the card against the CPU; ResNet-18/50 features in
bf16 on the card against float32 on the CPU. The file imports no JAX or
flax, so it runs on the card's machine; its tests carry the ``gpu`` marker
and skip without a card. tests/test_torch_dtfd.py, test_torch_sam.py and
test_torch_resnet.py hold the CPU path against the JAX package.
"""

import copy

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (create_train_state, get_family,
                                    make_train_step)
from acmil_tpu_torch.models import build_mil_model, dtfd, fast
from acmil_tpu_torch.models.encoders import resnet
from acmil_tpu_torch.ops import attn_pool as ap
from acmil_tpu_torch.ops import prng

# the kernels' route against the plain forward on one bag:
# tests/test_torch_gpu_clam.py's route bound
ROUTE_RTOL, ROUTE_ATOL = 2e-4, 3e-5
WIDTHS = ((384, 128), (512, 256))
# a distilled instance the fused route would choose otherwise must tie the
# plain route's within this (chip_smoke.py's DTFD_TIE_ATOL)
TIE_ATOL = 1e-6
# bf16 trunk against float32: per-row cosine
COSINE_MIN = 0.999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the DTFD/SAM/ResNet card path needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conf(arch, df, l, **kw):
    d = dict(arch=arch, n_class=2, D_feat=df, D_inner=l, seed=3, lr=1e-3,
             wd=1e-4, train_epoch=2, numGroup=4, total_instance=4)
    d.update(kw)
    return Config.from_dict(d)


def _bag(device, df, b=2, n=4096, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((b, n), bool)
    mask[0, 3000:] = False
    feats = (rs.randn(b, n, df) * mask[..., None]).astype(np.float16)
    return Bag(torch.from_numpy(feats).to(device),
               torch.from_numpy(mask).to(device),
               torch.zeros(b, n, 2, dtype=torch.int32, device=device),
               torch.tensor([0, 1], device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("df, l", WIDTHS)
def test_dtfd_route_matches_plain_on_the_card(cuda_device, df, l,
                                              monkeypatch):
    conf = _conf("dtfd", df, l)
    model, _ = build_mil_model(conf)
    model.to(cuda_device)
    bag = _bag(cuda_device, df)
    fam = get_family("dtfd")
    conf_d = fam.conf_dict(conf)
    u = torch.rand(bag.mask.shape, device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(0))
    outs, grads = [], []
    before = (ap.fused_gated_attn_pool_batched.launches,
              ap.fused_gated_attn_pool_bwd.launches)
    # the fused route distils the plain route's instances: CAM probabilities
    # near 0.5 tie within an ulp, which the routes may round apart
    chosen = []
    real = dtfd.first_k

    def replay(score, k):
        own = real(score, k)
        if len(chosen) < 2:                  # the plain run: top, bottom
            chosen.append((score.detach(), own))
            return own
        s0, idx = chosen[len(chosen) - 2]
        chosen.append(None)
        differ = own != idx
        for s in (s0, score.detach()):
            gap = (s.gather(-1, own) - s.gather(-1, idx)).abs()[differ]
            assert gap.numel() == 0 or float(gap.max()) <= TIE_ATOL
        return idx

    monkeypatch.setattr(dtfd, "first_k", replay)
    for route in (None, fast.dtfd_apply_fused):
        model.zero_grad()
        out = (route(model, bag.feats, bag.mask, deterministic=False,
                     group_u=u) if route else
               model(bag.feats, bag.mask, deterministic=False, group_u=u))
        loss, _ = fam.loss(out, bag, bag.mask.any(dim=1), conf_d)
        loss.backward()
        outs.append(out)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    after = (ap.fused_gated_attn_pool_batched.launches,
             ap.fused_gated_attn_pool_bwd.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for key in ("logits", "sub_preds"):
        torch.testing.assert_close(outs[0][key], outs[1][key],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    valid = outs[0]["attn"] > -1e8
    torch.testing.assert_close(outs[0]["attn"][valid], outs[1]["attn"][valid],
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    for name in grads[1]:
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL,
                                   msg=name)


@pytest.mark.gpu
def test_eval_uniforms_on_the_card_equal_the_cpu(cuda_device):
    got = prng.eval_uniforms((2, 65536), cuda_device)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), prng.eval_uniforms((2, 65536), "cpu"))


@pytest.mark.gpu
def test_one_sam_step_on_the_card_matches_the_cpu(cuda_device):
    conf = _conf("ga", 384, 128, n_token=5, n_masked_patch=10, mask_drop=0.6,
                 use_sam=True)
    cpu_model, fam = build_mil_model(conf)
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    u = torch.rand(2, 5, 4096, generator=torch.Generator().manual_seed(1))
    auxes = []
    for model, dev in ((card_model, cuda_device), (cpu_model, "cpu")):
        state = create_train_state(model, conf, 2, family=fam)
        before = ap.fused_gated_attn_pool_batched.launches
        aux = make_train_step(model, conf, fam)(state, _bag(dev, 384),
                                                stkim_u=u.to(dev))
        launched = ap.fused_gated_attn_pool_batched.launches - before
        assert launched == (2 if dev == cuda_device else 0)
        auxes.append({k: float(v) for k, v in aux.items()})
    for k in auxes[1]:
        np.testing.assert_allclose(auxes[0][k], auxes[1][k], rtol=1e-3,
                                   err_msg=k)
    for (n, p), q in zip(card_model.named_parameters(),
                         cpu_model.parameters()):
        # Adam's first step is about lr * sign(g): rounding-noise gradients
        # may step apart by up to lr
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0,
                                   atol=conf.lr, msg=n)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_bf16_on_the_card_matches_f32_on_the_cpu(cuda_device, name):
    torch.manual_seed(0)
    cpu = getattr(resnet, name)(torch.float32).eval()
    card = copy.deepcopy(cpu)
    card.dtype = torch.bfloat16
    card = card.to(cuda_device).cast_convs_(torch.bfloat16)
    x = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(cuda_device)).float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert torch.isfinite(got).all() and float(cos.min()) >= COSINE_MIN
