"""The CUDA chains of kernels B3 and B4 (acmil_tpu_torch/ops/vit_layer.py)
against their plain versions on the card. The file imports no JAX or flax,
so it runs on a machine that has neither; here, without a card, the ``gpu``
tests skip. tests/test_torch_vit_layer.py holds the plain versions against
the JAX package's Pallas kernels."""

import numpy as np
import pytest
import torch

from acmil_tpu_torch.ops import vit_layer as port

# bf16 both: the same rounding points, so only the order of f32 sums differs
# and may flip a bf16 rounding (of y, qkv, p, o or the gelu output); a
# flipped p can land on an output that cancels to near 0, so the bound is
# two bf16 steps (2**-8 each) of each output and of the largest output
BF16_TOL = 2.0 ** -6


def _weights(rs, d, hidden, ls1=False):
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    w = {"norm1.weight": 1 + 0.1 * f(d), "norm1.bias": 0.1 * f(d),
         "norm2.weight": 1 + 0.1 * f(d), "norm2.bias": 0.1 * f(d),
         "attn.qkv.weight": 0.1 * f(3 * d, d), "attn.qkv.bias": 0.05 * f(3 * d),
         "attn.proj.weight": 0.1 * f(d, d), "attn.proj.bias": 0.05 * f(d),
         "mlp.fc1.weight": 0.1 * f(hidden, d), "mlp.fc1.bias": 0.05 * f(hidden),
         "mlp.fc2.weight": 0.1 * f(d, hidden), "mlp.fc2.bias": 0.05 * f(d)}
    if ls1:
        w["ls1.gamma"] = 0.25 + 0.5 * torch.from_numpy(
            rs.rand(d).astype(np.float32))
    return w


def _case(dev, b, n, d, hidden, ls1=False, seed=10):
    rs = np.random.RandomState(seed)
    w = _weights(rs, d, hidden, ls1)
    x = torch.from_numpy(rs.randn(b, n, d).astype(np.float32))
    return x.to(dev, torch.bfloat16), {k: v.to(dev) for k, v in w.items()}


@pytest.mark.parametrize("dtype, heads, match", [
    (torch.float32, 6, "bfloat16"),
    (torch.float16, 6, "bfloat16"),
    (torch.bfloat16, 5, "head widths"),
])
def test_chain_arg_check_rejects(dtype, heads, match):
    x, w = _case("cpu", 1, 8, 384, 1536)
    with pytest.raises(ValueError, match=match):
        port._check_chain_args(x.to(dtype), w, heads, mlp=True)


def test_chain_arg_check_accepts_the_trunk_widths():
    for d, heads in ((384, 6), (768, 12), (1024, 16)):
        x, w = _case("cpu", 1, 4, d, 4 * d)
        port._check_chain_args(x, w, heads, mlp=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B3 and B4 are CUDA C++ for sm_90a: needs an "
                    "NVIDIA card")
    return torch.device("cuda")


def _check(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL * float(want.float().abs().max()))


@pytest.mark.gpu
def test_float32_on_the_card_raises(cuda_device):
    x, w = _case(cuda_device, 2, 50, 64, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        port.fused_vit_layer(x.float(), w, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        port.fused_vit_attn_half(x.float(), w, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n", [(3, 197), (2, 50)])
def test_b3_chain_matches_plain_on_card(cuda_device, b, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, b, n, 384, 1536)
    before = port.fused_vit_layer.launches
    with torch.no_grad():
        got = port.fused_vit_layer(x, w, 6)
        torch.cuda.synchronize()
        want = port._reference_layer(x, w, 6)
    assert port.fused_vit_layer.launches == before + 1
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ls1", [True, False])
def test_b4_chain_matches_plain_on_card(cuda_device, ls1):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, 2, 197, 768, 3072, ls1)
    before = port.fused_vit_attn_half.launches
    with torch.no_grad():
        got = port.fused_vit_attn_half(x, w, 12)
        torch.cuda.synchronize()
        want = port._reference_attn_half(x, w, 12)
    assert port.fused_vit_attn_half.launches == before + 1
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind, b, n, d, heads", [
    ("layer", 2, 785, 384, 6),      # ViT-S/8: 785 tokens fail fits_vmem
    ("half", 2, 577, 1024, 16),     # CLIP-L/336: fails attn_half_fits
])
def test_chains_launch_outside_the_tpu_vmem_models(cuda_device, kind, b, n,
                                                   d, heads):
    # the VMEM models pick routes in vit_encode; on the card the wrappers
    # launch at any such width, never the unfused plain path
    torch.backends.cuda.matmul.allow_tf32 = False
    n_pad = (n + 15) // 16 * 16
    if kind == "layer":
        assert not port.fits_vmem(d, 4 * d, n_pad, heads)
        fused, plain = port.fused_vit_layer, port._reference_layer
    else:
        assert not port.attn_half_fits(d, n_pad, heads)
        fused, plain = port.fused_vit_attn_half, port._reference_attn_half
    x, w = _case(cuda_device, b, n, d, 4 * d)
    before = fused.launches
    with torch.no_grad():
        got = fused(x, w, heads)
        torch.cuda.synchronize()
        want = plain(x, w, heads)
    assert fused.launches == before + 1
    _check(got, want)
