"""Kernel B7's port (acmil_tpu_torch/ops/vit_attn.py) against the JAX
package's ``fused_vit_attention``: its Pallas kernel in interpret mode for
the forward, ``jax.grad`` through its ``custom_vjp`` for the backward.

The same numpy q, k, v go through both. On CPU tensors the port takes its
plain version; the CUDA kernel is held against that plain version on the
card (tests/test_torch_gpu_b6_b7.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import vit_attn as jax_va
from acmil_tpu_torch.ops import vit_attn as port

# f32 on both sides: only the order of the sums differs
F32_TOL = 3e-5
# bf16: the same rounding points (f32 scores and softmax, p rounded to bf16,
# f32 PV sums rounded once), so a different summation order can flip one
# bf16 rounding of p or of the output: one bf16 step, 2**-8 relative
BF16_TOL = 2.0 ** -7
SHAPES = [(1, 2, 128, 32), (2, 3, 50, 32)]
# token counts at the edges of csrc/vit_attn.cu (tests/test_torch_vit_attn.py)
RAGGED_N = (1, 15, 16, 17, 63, 64, 65, 197, 577, 785)


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [None, 0.3])
def test_plain_matches_pallas_kernel_f32(shape, scale):
    q, k, v = _qkv(0, shape)
    want = np.asarray(jax_va.fused_vit_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = port.fused_vit_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # in f32 the JAX reference is the same function
    ref = np.asarray(jax_va._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("n", RAGGED_N)
def test_plain_matches_pallas_kernel_at_ragged_n(n):
    # the oracle of the card's kernel, checked where the kernel masks: the
    # ragged last key chunk of every N (the Pallas kernel pads N to 128)
    q, k, v = _qkv(20 + n, (1, 2, n, 16))
    want = np.asarray(jax_va.fused_vit_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3))
    got = port.fused_vit_attention(*map(torch.from_numpy, (q, k, v)), 0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_bf16(shape):
    q, k, v = _qkv(1, shape)
    want = np.asarray(jax_va.fused_vit_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))).astype(
            jnp.float32))
    got = port.fused_vit_attention(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_grad(shape):
    # f32, where JAX's backward (autodiff of its reference) and the port's
    # (autograd of its plain version) differentiate the same function
    q, k, v = _qkv(2, shape)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_va.fused_vit_attention(q, k, v) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (port.fused_vit_attention(*ins) * torch.from_numpy(g)).sum().backward()
    for t, w, name in zip(ins, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=1e-4, err_msg=f"d{name}")


def test_gradient_reaches_only_the_inputs_that_need_it():
    q, k, v = (torch.from_numpy(t) for t in _qkv(4, SHAPES[1]))
    k.requires_grad_()
    port.fused_vit_attention(q, k, v).sum().backward()
    assert k.grad is not None and q.grad is None and v.grad is None


def test_strided_views_match_contiguous_inputs():
    # q, k, v cut from one packed qkv, as a fused qkv Linear emits them
    rs = np.random.RandomState(5)
    qkv = torch.from_numpy(rs.randn(2, 50, 3, 3, 32).astype(np.float32))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = port.fused_vit_attention(q, k, v)
    want = port._reference_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_route_launches_no_kernel():
    before = port.fused_vit_attention.launches
    port.fused_vit_attention(*(torch.from_numpy(t)
                               for t in _qkv(6, SHAPES[1])))
    assert port.fused_vit_attention.launches == before


# fp16: the bf16 rule with fp16's step (2**-11 relative)
FP16_TOL = 2.0 ** -10
# head widths off the tensor-core route's {16, 32, 64, 128}, up to B7's 256
WIDE_DH = (48, 80, 256)


@pytest.mark.parametrize("dh", WIDE_DH)
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_plain_matches_pallas_kernel_at_every_width(dtype, dh):
    # the oracle of the card's fma route: float32 and float16 at head widths
    # the tensor-core route does not take
    q, k, v = _qkv(30 + dh, (2, 2, 50, dh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_va.fused_vit_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), 0.2).astype(jnp.float32))
    got = port.fused_vit_attention(*(torch.from_numpy(t).to(tdt)
                                     for t in (q, k, v)), 0.2)
    assert got.dtype == tdt and got.shape == (2, 2, 50, dh)
    tol = F32_TOL if dtype == "float32" else FP16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_out_takes_the_result_through_a_token_major_view():
    # the tensor-parallel block's call: q, k, v strided views of a packed
    # qkv [B, N, 3, H, dh], the result written into a [B, N, H*dh] buffer
    rs = np.random.RandomState(8)
    qkv = torch.from_numpy(rs.randn(2, 50, 3, 4, 48).astype(np.float32))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    buf = torch.full((2, 50, 4 * 48), float("nan"))
    got = port.fused_vit_attention(q, k, v,
                                   out=buf.view(2, 50, 4, 48).transpose(1, 2))
    want = port._reference_attention(q, k, v)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(buf, want.transpose(1, 2).reshape(2, 50, -1),
                               atol=0, rtol=0)
