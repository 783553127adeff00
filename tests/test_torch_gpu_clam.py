"""CLAM's use of kernels B1 and B2: the softmax-one pooling
(``ops/attn_pool.py::gated_attn_pool_grad_one``) and ``models/fast.py``'s
CLAM route, against their plain versions at the pretrain widths. The file
imports no JAX or flax, so it also runs on a machine that has neither: on
the CPU the wrapper's closed-form backward (B2's plain version under
lse₁) is held against autograd through the plain twin, and on a card (the
``gpu`` tests; they skip here) the kernels are held against the plain
twin. tests/test_torch_clam.py holds the plain versions against JAX.
"""

import copy

import numpy as np
import pytest
import torch

from acmil_tpu_torch.models import CLAM_MB, CLAM_SB, fast
from acmil_tpu_torch.ops import attn_pool as ap

# f32 both with TF32 off: the closed form against autograd on the CPU, and
# the kernels' split-TF32 products against plain products on the card,
# differ in the order of sums only; an fp16 dx is rounded once to fp16
REL, REL_FP16 = 1e-4, 1e-3
# CLAM's route against the plain forward on one bag: tests/test_attn_pool.py's
# bound for the JAX package's own fused CLAM
ROUTE_RTOL, ROUTE_ATOL = 2e-4, 3e-5
WIDTHS = ((384, 128), (512, 256))


def _rel_to_max(got, want) -> float:
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30)


def _inputs(dev, df, l, k, b=3, n=300, dtype=torch.float32, seed=0):
    """A batch with one all-masked bag, the kernels' weights at width
    (df, l) with A = 128, and cotangents nonzero at pad slots too."""
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    feats = f(b, n, df).to(dev, dtype)
    mask = torch.from_numpy(rs.rand(b, n) < 0.8).to(dev)
    mask[-1] = False
    a = ap.KERNEL_A
    ws = [(f(*s) * sc).to(dev) for s, sc in (
        ((df, l), df ** -0.5), ((l,), 0.1), ((l, a), l ** -0.5), ((a,), 0.1),
        ((l, a), l ** -0.5), ((a,), 0.1), ((a, k), a ** -0.5), ((k,), 0.1))]
    cot = (f(b, k, l).to(dev), f(b, k, n).to(dev))
    return feats, mask, ws, cot


def _vjp(fn, feats, mask, ws, cot):
    x = feats.clone().requires_grad_()
    w = [t.clone().requires_grad_() for t in ws]
    bag, logits = fn(x, mask, *w)
    grads = torch.autograd.grad((bag, logits), [x, *w], cot)
    return bag.detach(), logits.detach(), grads


def _check_pool(got, want, mask, dx_rel):
    bag, logits, grads = got
    bag_w, logits_w, grads_w = want
    assert torch.isfinite(bag).all() and (bag[-1] == 0).all()
    assert _rel_to_max(bag, bag_w) <= REL
    valid = mask[:, None, :].expand_as(logits)
    assert _rel_to_max(logits[valid], logits_w[valid]) <= REL
    names = ("dx", "dW1", "db1", "dV", "dbv", "dU", "dbu", "dw", "dbw")
    for g, w, name in zip(grads, grads_w, names):
        assert torch.isfinite(g).all(), name
        assert _rel_to_max(g, w) <= (dx_rel if name == "dx" else REL), name


@pytest.mark.parametrize("df, l", WIDTHS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_cpu_route_backward_is_autograd_of_the_plain_twin(df, l, k):
    """On the CPU the wrapper runs the plain twin forward and B2's closed
    form under lse₁ = logaddexp(0, lse) backward; both must equal autograd
    through the plain twin."""
    args = _inputs("cpu", df, l, k, seed=k)
    got = _vjp(ap.gated_attn_pool_grad_one, *args)
    want = _vjp(ap.gated_attn_pool_one_reference, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _check_pool(got, want, args[1], REL)


def test_softmax_one_weights_sum_below_one():
    """The plain twin's weights are exp(a) / (1 + sum exp(a)): pooling ones
    gives their sum, which the phantom logit keeps under 1 (0 for the
    all-masked bag)."""
    feats, mask, ws, _ = _inputs("cpu", 384, 128, 2)
    w1 = torch.zeros_like(ws[0])
    b1 = torch.ones_like(ws[1])                  # h = relu(0 + 1) = 1
    bag, logits = ap.gated_attn_pool_one_reference(feats, mask, w1, b1,
                                                   *ws[2:])
    a = logits.amax(dim=-1)          # every valid row's logit is the same
    n = mask.sum(dim=1)[:, None].float()
    want = n * torch.exp(a) / (1 + n * torch.exp(a))
    torch.testing.assert_close(bag[..., 0], torch.where(n > 0, want, 0.0))
    assert (bag[..., 0] < 1).all()


@pytest.mark.parametrize("cls", [CLAM_SB, CLAM_MB])
def test_cpu_route_matches_the_module(cls):
    """``clam_apply_fused`` on the CPU (the kernels' plain versions) against
    the module's forward at the camelyon_medical_ssl widths, 4 classes
    (subtyping on): outputs, instance loss and every gradient."""
    torch.manual_seed(0)
    model = cls(n_class=4, d_feat=384, d_inner=128, droprate=0,
                generator=torch.Generator().manual_seed(3))
    feats, mask, _, _ = _inputs("cpu", 384, 128, 1, n=400, seed=5)
    label = torch.tensor([1, 3, 0])
    outs, grads = [], []
    for fused in (True, False):
        m = copy.deepcopy(model).train()
        if fused:
            out = fast.clam_apply_fused(m, feats, mask, label=label,
                                        instance_eval=True, n_class=4,
                                        subtyping=True)
        else:
            out = m(feats, mask, label=label, instance_eval=True)
        (out["logits"].sum() + out["instance_loss"]).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for key in ("logits", "bag_feat", "instance_loss"):
        torch.testing.assert_close(outs[0][key], outs[1][key],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    valid = mask[:, None, :].expand_as(outs[0]["attn"])
    torch.testing.assert_close(outs[0]["attn"][valid],
                               outs[1]["attn"][valid])
    for name in grads[1]:
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL,
                                   msg=name)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B1 and B2 are CUDA C++ for sm_90a: need an "
                    "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("df, l", WIDTHS)
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_softmax_one_kernels_match_plain_on_card(cuda_device, df, l, k,
                                                 dtype):
    args = _inputs(cuda_device, df, l, k, n=4099, dtype=dtype, seed=k)
    before = (ap.fused_gated_attn_pool_batched.launches,
              ap.fused_gated_attn_pool_bwd.launches)
    got = _vjp(ap.gated_attn_pool_grad_one, *args)
    after = (ap.fused_gated_attn_pool_batched.launches,
             ap.fused_gated_attn_pool_bwd.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    feats32 = args[0].float()
    want = _vjp(ap.gated_attn_pool_one_reference, feats32, *args[1:])
    _check_pool(got, want, args[1],
                REL_FP16 if dtype == torch.float16 else REL)
    assert got[2][0].dtype == dtype


@pytest.mark.gpu
@pytest.mark.parametrize("cls", [CLAM_SB, CLAM_MB])
@pytest.mark.parametrize("n_class", [2, 4])
def test_clam_route_matches_the_module_on_card(cuda_device, cls, n_class):
    model = cls(n_class=n_class, d_feat=384, d_inner=128, droprate=0,
                generator=torch.Generator().manual_seed(n_class))
    feats, mask, _, _ = _inputs(cuda_device, 384, 128, 1, n=20000,
                                dtype=torch.float16, seed=7)
    label = torch.arange(3, device=cuda_device) % n_class
    outs, grads = [], []
    for fused in (True, False):
        m = copy.deepcopy(model).to(cuda_device).train()
        kw = dict(label=label, instance_eval=True)
        out = (fast.clam_apply_fused(m, feats, mask, n_class=n_class,
                                     subtyping=n_class > 2, **kw)
               if fused else m(feats, mask, **kw))
        (out["logits"].sum() + out["instance_loss"]).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for key in ("logits", "bag_feat", "instance_loss"):
        torch.testing.assert_close(outs[0][key], outs[1][key],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    for name in grads[1]:
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL,
                                   msg=name)
