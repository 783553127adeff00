"""Kernel B7's fma route (``csrc/vit_attn_generic.cu``: float32, float16,
bfloat16 at any head width up to 256) and its tf32x3 route
(``csrc/vit_attn_f32.cu``: float32 at head widths 16, 32, 64, 128) against
its plain version on the card, and the tensor-parallel block
(``parallel/tp.py``) at world 1 on the card against the one-process module. The file imports no JAX or flax, so
it runs on a machine that has neither; here, without a card, every test
skips. tests/test_torch_vit_attn_b7.py holds the plain version against the
JAX package's Pallas kernel, tests/test_torch_tp.py the TP forward against
JAX's on the CPU.
"""

import numpy as np
import pytest
import torch

from acmil_tpu_torch.ops import vit_attn

# float32: only the order of the f32 sums and exp's rounding differ
F32_TOL = 1e-5
# float16 and bfloat16: one step of p's or the output's rounding may flip,
# on an output and on the largest output (the bf16 rule of
# tests/test_torch_gpu_b6_b7.py, with each dtype's step)
LOW_TOL = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}
# a small ViT (ViT-S/16's head width and token count, two layers)
TRUNK = dict(patch=16, dim=256, depth=2, heads=4, img_size=224)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B7 is CUDA C++ for sm_90a: need an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(q, k, v, scale=None, out=None):
    before = dict(vit_attn.fused_vit_attention.route_launches)
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(q, k, v, scale, out=out)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(q, k, v, scale)
    route = vit_attn._route(q, k, v, got)
    assert vit_attn.fused_vit_attention.route_launches[route] == \
        before[route] + 1
    tol = F32_TOL if q.dtype == torch.float32 else LOW_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))
    return route


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 17, 64, 65, 197, 577])
@pytest.mark.parametrize("dh", [1, 16, 48, 64, 80, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_b7_fma_route_matches_plain_on_card(cuda_device, dtype, dh, n):
    rs = np.random.RandomState(dh + n)
    q, k, v = (torch.from_numpy(2 * rs.randn(2, 3, n, dh).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(3))
    route = _check(q, k, v, scale=0.3)
    # the tensor cores' head widths: mma at fp16 and bf16, tf32x3 at f32
    assert route == ("fma" if dh not in (16, 64) else
                     "tf32x3" if dtype == torch.float32 else "mma")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_b7_fma_route_on_strided_views_into_a_token_major_buffer(
        cuda_device, dtype):
    rs = np.random.RandomState(3)
    qkv = torch.from_numpy(rs.randn(4, 197, 3, 6, 80).astype(
        np.float32)).to(cuda_device, dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    buf = torch.full((4, 197, 6 * 80), float("nan"), device=cuda_device,
                     dtype=dtype)
    assert _check(q, k, v, out=buf.view(4, 197, 6, 80).transpose(1, 2)) \
        == "fma"
    assert torch.isfinite(buf).all()


@pytest.mark.gpu
@pytest.mark.parametrize("heads, dh", [(6, 64), (3, 128), (8, 16)])
def test_b7_tf32x3_route_into_a_token_major_buffer(cuda_device, heads, dh):
    # the TP block's f32 call: strided q, k, v of a packed local qkv, the
    # result into a token-major buffer that starts as NaN
    rs = np.random.RandomState(heads + dh)
    qkv = torch.from_numpy(rs.randn(4, 197, 3, heads, dh).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    buf = torch.full((4, 197, heads * dh), float("nan"), device=cuda_device)
    assert _check(q, k, v, out=buf.view(4, 197, heads, dh).transpose(1, 2)) \
        == "tf32x3"
    assert torch.isfinite(buf).all()


@pytest.mark.gpu
def test_b7_f32_unaligned_view_takes_the_fma_route(cuda_device):
    # a token stride of 66 floats: rows off 16-byte boundaries
    rs = np.random.RandomState(4)
    wide = torch.from_numpy(rs.randn(2, 3, 65, 66).astype(np.float32)).to(
        cuda_device)[..., :64]
    q, k = (torch.from_numpy(rs.randn(2, 3, 65, 64).astype(np.float32)).to(
        cuda_device) for _ in range(2))
    assert _check(q, k, wide, scale=0.3) == "fma"


@pytest.mark.gpu
def test_b7_raises_above_its_head_width(cuda_device):
    q = torch.zeros(1, 1, 8, 272, device=cuda_device)
    with pytest.raises(ValueError, match="up to 256"):
        vit_attn.fused_vit_attention(q, q, q)


def _trunk(dtype):
    from acmil_tpu_torch.models.encoders.vit import ViT

    torch.manual_seed(0)
    return ViT(**TRUNK, dtype=dtype).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_block_at_world_one_on_card(cuda_device, dtype):
    from acmil_tpu_torch.models.encoders.fast import vit_encode
    from acmil_tpu_torch.parallel.tp import (_tp_vit_local,
                                             shard_vit_params_tp)

    enc = _trunk(dtype)
    params = {k: v.to(cuda_device) for k, v in shard_vit_params_tp(
        enc.state_dict(), heads=TRUNK["heads"], tp=1, index=0).items()}
    x = torch.randn(3, 224, 224, 3, generator=torch.Generator().manual_seed(
        1)).to(cuda_device)
    kw = dict(patch=16, depth=TRUNK["depth"], act="gelu", pre_norm=False,
              proj_dim=None, dtype=dtype)
    before = dict(vit_attn.fused_vit_attention.route_launches)
    with torch.no_grad():
        got = _tp_vit_local(params, x, heads_local=TRUNK["heads"],
                            group=None, **kw).float()
        torch.cuda.synchronize()
    route = "tf32x3" if dtype == torch.float32 else "mma"
    assert vit_attn.fused_vit_attention.route_launches[route] == \
        before[route] + TRUNK["depth"]
    with torch.no_grad():
        if dtype == torch.float32:
            # the module forward computes the TP block's function at f32
            want = enc.to(cuda_device)(x)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-4, err
        else:
            want = vit_encode(params, x, heads=TRUNK["heads"], fused=False,
                              **kw).float()
            cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
            assert float(cos.min()) >= 0.999, cos
