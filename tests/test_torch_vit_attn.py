"""Kernel B5''s port (acmil_tpu_torch/ops/vit_attn_packed.py) against the
JAX package's packed-MHA Pallas kernel, run in interpret mode on the CPU.

The same numpy qkv goes through both. On CPU tensors the port's wrapper
takes its plain version; the CUDA kernel is held against that plain version
by the test marked ``gpu``, which runs only on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import vit_attn_packed as jax_packed
from acmil_tpu_torch.ops import vit_attn_packed as port

# f32 on both sides: only the order of the sums differs (the interpret-mode
# kernel's query chunks vs one torch matmul), as in the JAX package's own
# packed-MHA test
F32_TOL = 3e-5
# bf16: the same rounding points (f32 scores and softmax, p rounded to bf16,
# f32 PV sums rounded once), so a different summation order can flip one
# bf16 rounding of p or of the output: one bf16 step, 2**-8 relative
BF16_TOL = 2.0 ** -7


def _qkv(seed, b, n, d):
    rs = np.random.RandomState(seed)
    return rs.randn(b, n, 3 * d).astype(np.float32)


@pytest.mark.parametrize("b, n, d, heads", [(2, 50, 64, 2), (2, 197, 96, 3),
                                            (1, 577, 32, 2)])
def test_plain_matches_pallas_kernel(b, n, d, heads):
    # (1, 577, ...) crosses the JAX kernel's query chunking (N_pad 640,
    # chunks of 320)
    qkv = _qkv(0, b, n, d)
    want = np.asarray(jax_packed.fused_mha_packed(jnp.asarray(qkv), heads))
    got = port.fused_mha_packed(torch.from_numpy(qkv), heads)
    assert got.shape == (b, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_plain_matches_pallas_kernel_in_bf16():
    qkv = _qkv(1, 2, 50, 64)
    want = np.asarray(jax_packed.fused_mha_packed(
        jnp.asarray(qkv, jnp.bfloat16), 2).astype(jnp.float32))
    got = port.fused_mha_packed(torch.from_numpy(qkv).bfloat16(), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_plain_matches_jax_reference():
    qkv = _qkv(2, 3, 40, 64)
    want = np.asarray(jax_packed._reference_packed(jnp.asarray(qkv), 4))
    got = port._reference_packed(torch.from_numpy(qkv), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_cpu_route_launches_no_kernel():
    before = port.fused_mha_packed.launches
    port.fused_mha_packed(torch.from_numpy(_qkv(3, 1, 20, 32)), 2)
    assert port.fused_mha_packed.launches == before


@pytest.mark.parametrize("shape, dtype, heads, match", [
    ((2, 197, 3 * 384), torch.float32, 6, "bfloat16"),
    ((2, 197, 3 * 384), torch.bfloat16, 5, "head widths"),
    ((2, 197, 3 * 96), torch.bfloat16, 2, "head widths"),
    ((2, 197, 100), torch.bfloat16, 2, r"\[B, N, 3D\]"),
    ((2, 0, 3 * 64), torch.bfloat16, 1, "empty"),
])
def test_kernel_arg_check_rejects(shape, dtype, heads, match):
    with pytest.raises(ValueError, match=match):
        port._check_kernel_args(torch.zeros(shape, dtype=dtype), heads)


def test_kernel_arg_check_accepts_every_trunk_width():
    for d, heads in ((384, 6), (768, 12), (1024, 16), (1536, 24)):
        port._check_kernel_args(torch.zeros(1, 8, 3 * d, dtype=torch.bfloat16),
                                heads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B5' is CUDA C++ for sm_90a: needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads", [(2, 197, 384, 6), (1, 577, 1024, 16),
                                            (3, 50, 64, 2)])
def test_kernel_matches_plain_on_card(cuda_device, b, n, d, heads):
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = torch.from_numpy(_qkv(4, b, n, d) * 2).to(cuda_device, torch.bfloat16)
    before = port.fused_mha_packed.launches
    got = port.fused_mha_packed(qkv, heads)
    torch.cuda.synchronize()
    assert port.fused_mha_packed.launches == before + 1
    want = port._reference_packed(qkv, heads)
    # on the card a flipped p can land on an output that cancels to near 0:
    # the bound there is one bf16 step of the largest output
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL * float(want.float().abs().max()))
