"""The ViT trunks at float32 and float16 against the JAX package, and the
backward of kernels B3, B4 and B5'.

On CPU tensors the port's wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do. The same
numpy inputs, made from a seed, go through both. The CUDA chains are held
against these plain versions by the ``gpu`` tests of
tests/test_torch_vit_chains.py, tests/test_torch_gpu_gemm.py and
tests/test_torch_gpu_b6_b7.py, which import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.models.encoders import build as jax_build
from acmil_tpu.models.encoders.fast import vit_encode as jax_vit_encode
from acmil_tpu.models.encoders.vit import ViT as JaxViT
from acmil_tpu.ops import vit_attn_packed as jax_packed
from acmil_tpu.ops import vit_layer as jax_layer
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.models.encoders import build
from acmil_tpu_torch.models.encoders.fast import vit_encode
from acmil_tpu_torch.models.encoders.vit import ViT
from acmil_tpu_torch.ops import vit_attn_packed as port_packed
from acmil_tpu_torch.ops import vit_layer as port
from tests.test_torch_encoders import TRUNKS, _encode_kw, _flax
from tests.test_torch_vit_layer import _flax_weights, _jax, _port_weights

# float16 on both sides with the same rounding points: a different f32
# summation order can flip one float16 rounding (of y, qkv, p, o or the
# gelu output), and a flip moves an output of magnitude ~6 by one float16
# step there (2**-8); 2**-7 of the output and of its magnitude
F16_TOL = 2.0 ** -7
# the gradients at float32: the same unfused graph differentiated on both
# sides, sums in another order; relative to the gradient's largest entry
GRAD_TOL = 2e-5
# encoder_feature_fn at float32: fp16 features of f32 compute, so the two
# agree to a float16 rounding of the output
F32_FEAT_TOL = 2e-3


def _block(seed, b=2, n=50, d=64, hidden=256, ls1=False):
    rs = np.random.RandomState(seed)
    w = _flax_weights(rs, d, hidden, ls1)
    x = rs.randn(b, n, d).astype(np.float32)
    g = rs.randn(b, n, d).astype(np.float32)
    return x, w, g


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want.astype(jnp.float32)), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["layer", "half"])
def test_b3_b4_plain_match_pallas_kernels_in_float16(kind):
    x, w, _ = _block(11, ls1=kind == "half")
    jx = jnp.asarray(x, jnp.float16)
    tx = torch.from_numpy(x).half()
    if kind == "layer":
        want = jax_layer.fused_vit_layer(jx, _jax(w), 2)
        got = port.fused_vit_layer(tx, _port_weights(w), 2)
    else:
        want = jax_layer._attn_half_impl(jx, _jax(w), 2)
        got = port.fused_vit_attn_half(tx, _port_weights(w), 2)
    assert got.dtype == torch.float16
    _close(got, want, F16_TOL)


def test_b5_plain_matches_pallas_kernel_in_float16():
    qkv = (2 * np.random.RandomState(12).randn(2, 50, 3 * 64)).astype(
        np.float32)
    want = jax_packed.fused_mha_packed(jnp.asarray(qkv, jnp.float16), 2)
    got = port_packed.fused_mha_packed(torch.from_numpy(qkv).half(), 2)
    assert got.dtype == torch.float16
    _close(got, want, F16_TOL)


@pytest.mark.parametrize("case", sorted(TRUNKS))
def test_vit_encode_matches_jax_in_float16(case):
    m, params, x = _flax(case, seed=13)
    want = jax_vit_encode(params, jnp.asarray(x),
                          **_encode_kw(m, jnp.float16))
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "vit")
    got = vit_encode(sd, torch.from_numpy(x), **_encode_kw(m, torch.float16))
    assert got.dtype == torch.float16
    _close(got, want, F16_TOL)


# ---------------------------------------------------------------------------
# The backward: autograd of the function the JAX custom_vjp differentiates
# ---------------------------------------------------------------------------

def _jax_block_grads(fn, x, w, g):
    """jax.vjp of ``fn(x, w)`` at the cotangent g: dx and the weight tree's
    gradients, in the port's names and layouts (Linear weights [out, in])."""
    _, vjp = jax.vjp(fn, jnp.asarray(x), _jax(w))
    gx, gw = vjp(jnp.asarray(g))
    gw = jax.tree_util.tree_map(np.asarray, gw)
    return np.asarray(gx), {k: v.numpy() for k, v in _port_weights(gw).items()}


def _port_block_grads(fn, x, w, g):
    tw = {k: v.requires_grad_() for k, v in _port_weights(w).items()}
    tx = torch.from_numpy(x).requires_grad_()
    names = sorted(tw)
    grads = torch.autograd.grad(fn(tx, tw, 2), [tx] + [tw[k] for k in names],
                                torch.from_numpy(g))
    return grads[0].numpy(), dict(zip(names, (t.numpy() for t in grads[1:])))


def _grad_close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("kind, ls1", [("layer", False), ("half", False),
                                       ("half", True)])
def test_block_gradients_match_jax_grad(kind, ls1):
    # B3's backward is that of the unfused layer with exact gelu, as JAX's
    # custom_vjp; its forward (the kernel's plain version) uses tanh gelu
    x, w, g = _block(14, ls1=ls1)
    jfn = (jax_layer.fused_vit_layer if kind == "layer"
           else jax_layer.fused_vit_attn_half)
    tfn = port.fused_vit_layer if kind == "layer" else port.fused_vit_attn_half
    want_x, want_w = _jax_block_grads(lambda a, b: jfn(a, b, 2), x, w, g)
    got_x, got_w = _port_block_grads(tfn, x, w, g)
    _grad_close(got_x, want_x, "dx")
    assert set(got_w) == set(want_w)
    for name in sorted(want_w):
        _grad_close(got_w[name], want_w[name], name)


def test_b5_gradient_matches_jax_grad():
    rs = np.random.RandomState(15)
    qkv = (2 * rs.randn(2, 50, 3 * 64)).astype(np.float32)
    g = rs.randn(2, 50, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_packed.fused_mha_packed(t, 2),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(qkv).requires_grad_()
    (got,) = torch.autograd.grad(port_packed.fused_mha_packed(t, 2), t,
                                 torch.from_numpy(g))
    _grad_close(got.numpy(), np.asarray(want), "dqkv")


def test_unused_weights_get_zero_gradients():
    # B4 reads no MLP weight: JAX's vjp returns zeros for them, and so does
    # the port's backward
    x, w, g = _block(16)
    tw = {k: v.requires_grad_() for k, v in _port_weights(w).items()}
    tw["mlp.fc1.weight"] = torch.zeros(256, 64, requires_grad=True)
    out = port.fused_vit_attn_half(torch.from_numpy(x), tw, 2)
    (gw,) = torch.autograd.grad(out, [tw["mlp.fc1.weight"]],
                                torch.from_numpy(g))
    assert torch.equal(gw, torch.zeros(256, 64))


# ---------------------------------------------------------------------------
# Step2's closure at float32 and float16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_case():
    m, params, _ = _flax("vits", seed=17)
    u8 = np.random.RandomState(18).randint(0, 256, (3, 32, 32, 3)).astype(
        np.uint8)
    return params, u8


@pytest.mark.parametrize("dtype, tol", [("float32", F32_FEAT_TOL),
                                        ("float16", F16_TOL)])
def test_encoder_feature_fn_matches_jax(feature_case, dtype, tol):
    params, u8 = feature_case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    spec_j = jax_build.EncoderSpec(
        lambda dt: JaxViT(**TRUNKS["vits"], dtype=dt), 64, 32,
        jax_build.HALF_MEAN, jax_build.HALF_STD, "vit", depth=2)
    spec_t = build.EncoderSpec(
        lambda dt: ViT(**TRUNKS["vits"], dtype=dt), 64, 32,
        build.HALF_MEAN, build.HALF_STD, "vit", depth=2)
    jmodel = jax_build.CustomModel(encoder=spec_j.builder(jdt), n_class=2)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = {"params": {**variables["params"], "encoder": params}}
    want = jax_build.encoder_feature_fn(jmodel, variables, spec_j)(u8)
    tmodel = build.CustomModel(spec_t.builder(tdt), 2)
    tmodel.encoder.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "vit"))
    got = build.encoder_feature_fn(tmodel, spec_t, torch.device("cpu"))(u8)
    assert got.dtype == torch.float16 and got.shape == (3, 64)
    _close(got, want, tol)
