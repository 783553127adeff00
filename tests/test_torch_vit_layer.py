"""Kernels B3 and B4's ports (acmil_tpu_torch/ops/vit_layer.py) against the
JAX package's Pallas kernels in interpret mode, and the unfused layer
functions and route predicates against JAX's.

On CPU tensors the port's wrappers take their plain versions; the CUDA
chains are held against those plain versions by the ``gpu`` tests of
tests/test_torch_vit_chains.py, which import no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.models.encoders.build import ENCODER_SPECS as JAX_SPECS
from acmil_tpu.ops import vit_layer as jax_layer
from acmil_tpu_torch.models.encoders.build import ENCODER_SPECS
from acmil_tpu_torch.ops import vit_layer as port

# f32 on both sides: the order of the sums differs (interpret-mode Pallas
# dots over padded rows vs torch matmuls) through LN, four products and a
# softmax of 50 keys
F32_TOL = 2e-5
# bf16: the port's plain versions keep every rounding point of the Pallas
# kernels, so only a different f32 summation order flipping a bf16 rounding
# (of y, qkv, p, o or the gelu output) separates them; such a flip moves an
# output by about one bf16 step, 2**-8 relative, after the residual
BF16_TOL = 2.0 ** -6
# the unfused functions: f32, the same einsum graph on both sides
UNFUSED_TOL = 2e-5


def _flax_weights(rs, d, hidden, ls1=False):
    lin = lambda i, o: {"kernel": (rs.randn(i, o) * 0.1).astype(np.float32),
                        "bias": (rs.randn(o) * 0.05).astype(np.float32)}
    ln = lambda: {"scale": (1 + 0.1 * rs.randn(d)).astype(np.float32),
                  "bias": (0.1 * rs.randn(d)).astype(np.float32)}
    w = {"ln1": ln(), "ln2": ln(), "qkv": lin(d, 3 * d), "proj": lin(d, d),
         "fc1": lin(d, hidden), "fc2": lin(hidden, d)}
    if ls1:
        w["ls1"] = (rs.rand(d) * 0.5 + 0.25).astype(np.float32)
    return w


def _port_weights(w, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    out = {"norm1.weight": w["ln1"]["scale"], "norm1.bias": w["ln1"]["bias"],
           "norm2.weight": w["ln2"]["scale"], "norm2.bias": w["ln2"]["bias"],
           "attn.qkv.weight": w["qkv"]["kernel"].T,
           "attn.qkv.bias": w["qkv"]["bias"],
           "attn.proj.weight": w["proj"]["kernel"].T,
           "attn.proj.bias": w["proj"]["bias"],
           "mlp.fc1.weight": w["fc1"]["kernel"].T,
           "mlp.fc1.bias": w["fc1"]["bias"],
           "mlp.fc2.weight": w["fc2"]["kernel"].T,
           "mlp.fc2.bias": w["fc2"]["bias"]}
    if "ls1" in w:
        out["ls1.gamma"] = w["ls1"]
    return {k: t(v) for k, v in out.items()}


def _jax(w):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in w.items()}


def _case(seed, b=2, n=50, d=64, hidden=256, ls1=False):
    rs = np.random.RandomState(seed)
    w = _flax_weights(rs, d, hidden, ls1)
    x = rs.randn(b, n, d).astype(np.float32)
    return x, w


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want.astype(jnp.float32)), atol=tol, rtol=tol)


def test_b3_plain_matches_pallas_kernel():
    x, w = _case(0)
    want = jax_layer.fused_vit_layer(jnp.asarray(x), _jax(w), 2)
    got = port.fused_vit_layer(torch.from_numpy(x), _port_weights(w), 2)
    _close(got, want, F32_TOL)


def test_b3_plain_matches_pallas_kernel_in_bf16():
    x, w = _case(1)
    want = jax_layer.fused_vit_layer(jnp.asarray(x, jnp.bfloat16), _jax(w), 2)
    got = port.fused_vit_layer(torch.from_numpy(x).bfloat16(),
                               _port_weights(w), 2)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("ls1", [True, False])
def test_b4_plain_matches_pallas_kernel(ls1):
    x, w = _case(2, ls1=ls1)
    want = jax_layer._attn_half_impl(jnp.asarray(x), _jax(w), 2)
    got = port.fused_vit_attn_half(torch.from_numpy(x), _port_weights(w), 2)
    _close(got, want, F32_TOL)


def test_b4_plain_matches_pallas_kernel_in_bf16():
    x, w = _case(3, ls1=True)
    want = jax_layer._attn_half_impl(jnp.asarray(x, jnp.bfloat16), _jax(w), 2)
    got = port.fused_vit_attn_half(torch.from_numpy(x).bfloat16(),
                                   _port_weights(w), 2)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_layer_matches_jax(dtype):
    x, w = _case(4)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_layer._unfused_layer(jx, _jax(w), 2)
    got = port._unfused_layer(tx, _port_weights(w), 2)
    _close(got, want, UNFUSED_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("ls1", [True, False])
def test_unfused_attn_half_matches_jax(ls1):
    x, w = _case(5, ls1=ls1)
    want = jax_layer._unfused_attn_half(jnp.asarray(x), _jax(w), 2)
    got = port._unfused_attn_half(torch.from_numpy(x), _port_weights(w), 2)
    _close(got, want, UNFUSED_TOL)


def test_unfused_attn_half_with_the_packed_mha_matches_jax():
    from acmil_tpu.ops.vit_attn_packed import fused_mha_packed as jax_mha
    from acmil_tpu_torch.ops.vit_attn_packed import fused_mha_packed

    x, w = _case(6, ls1=True)
    want = jax_layer._unfused_attn_half(jnp.asarray(x), _jax(w), 2,
                                        mha=jax_mha)
    got = port._unfused_attn_half(torch.from_numpy(x), _port_weights(w), 2,
                                  mha=fused_mha_packed)
    _close(got, want, UNFUSED_TOL)


def test_b3_falls_back_where_jax_does():
    # a D=512, hidden-4096 layer is outside the scoped-VMEM model, and both
    # packages then take _unfused_layer (exact gelu)
    x, w = _case(7, b=1, n=300, d=512, hidden=4096)
    assert not port.fits_vmem(512, 4096, 304, 2)
    want = jax_layer._unfused_layer(jnp.asarray(x), _jax(w), 2)
    got = port.fused_vit_layer(torch.from_numpy(x), _port_weights(w), 2)
    # f32 sums of 4096 terms in another order, outputs up to ~30
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-4)


def _trunk_shape(spec):
    enc = spec.builder(jnp.float32)
    patch, img = enc.patch, enc.img_size
    n_tok = (img // patch) ** 2 + 1
    return (enc.dim, int(enc.dim * enc.mlp_ratio), (n_tok + 15) // 16 * 16,
            enc.heads)


@pytest.mark.parametrize("key", [k for k, s in JAX_SPECS.items()
                                 if s.converter != "resnet"])
def test_route_predicates_match_jax_for_every_trunk(key):
    dim, hidden, n_pad, heads = _trunk_shape(JAX_SPECS[key])
    assert key in ENCODER_SPECS
    for bpe in (2, 4):
        assert port.fits_vmem(dim, hidden, n_pad, heads, bpe) == \
            jax_layer.fits_vmem(dim, hidden, n_pad, heads, bpe)
        for g in (1, 2, 4):
            assert port.attn_half_fits(dim, n_pad, heads, g, bpe) == \
                jax_layer.attn_half_fits(dim, n_pad, heads, g, bpe)


def test_routes_of_the_named_trunks():
    # ViT-S/16: whole layer; ViT-B/16, UNI, ViT-S/8: attention half;
    # CLIP-L/336, GigaPath: packed MHA
    def route(key):
        dim, hidden, n_pad, heads = _trunk_shape(JAX_SPECS[key])
        enc = JAX_SPECS[key].builder(jnp.float32)
        if (enc.act == "gelu" and not enc.layerscale
                and port.fits_vmem(dim, hidden, n_pad, heads)):
            return "B3"
        return "B4" if port.attn_half_fits(dim, n_pad, heads) else "B5"

    assert route(("medical_ssl", "ViT-S/16")) == "B3"
    for key in (("natural_supervised", "ViT-B/16"), ("UNI", "ViT-L/16"),
                ("medical_ssl", "ViT-S/8")):
        assert route(key) == "B4"
    for key in (("path-clip-L-336", "ViT-L/336"), ("GigaPath", "ViT-G/16")):
        assert route(key) == "B5"


def test_cpu_route_launches_no_kernel():
    x, w = _case(8, b=1, n=20)
    before = (port.fused_vit_layer.launches, port.fused_vit_attn_half.launches)
    port.fused_vit_layer(torch.from_numpy(x), _port_weights(w), 2)
    port.fused_vit_attn_half(torch.from_numpy(x), _port_weights(w), 2)
    assert (port.fused_vit_layer.launches,
            port.fused_vit_attn_half.launches) == before
