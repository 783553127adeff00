"""Step3 across processes on the card: two ranks on one GPU, joined by
``gloo`` (which takes the CUDA tensors, through host memory), run kernels
B1 and B2 on their slices of each bag under the flash merge
(``ops/attn_pool.py::sharded_gated_attn_pool_grad``), and one sequence-
sharded ACMIL_GA step. Both are held against the one-process kernels on the
same card: a seq slice with no valid row and a bag with none are among the
inputs. The file imports no JAX, so it runs on the card's machine; its
tests carry the ``gpu`` marker and skip without a card.
tests/test_torch_parallel.py holds the CPU path against the JAX package.
"""

import datetime
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the JAX package's sharded-pool tolerance (tests/test_attn_pool.py)
POOL_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 2e-4, 2e-4
# one training step against one process: chip_smoke.py's phase 7 rules
STEP_LOSS_RTOL, STEP_GRAD_REL, STEP_GRAD_ATOL = 1e-5, 1e-3, 1e-7
DEADLINE, GROUP_TIMEOUT = 240, 120
B, N, DF, L, K = 3, 8192, 384, 128, 5


def _inputs(device):
    """Three bags of N fp16 rows: bag 0 ragged, bag 1 with no valid row in
    its second half (rank 1's slice), bag 2 all masked; the pooling's
    weights in f32."""
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(B, N, DF, generator=gen).half()
    mask = torch.rand(B, N, generator=gen) < 0.8
    mask[0, 7000:] = False
    mask[1, N // 2:] = False
    mask[2] = False
    a = 128
    shapes = [(DF, L), (L,), (L, a), (a,), (L, a), (a,), (a, K), (K,)]
    ws = [torch.randn(*s, generator=gen) * s[0] ** -0.5 for s in shapes]
    ws[1] = torch.zeros(L)
    return feats.to(device), mask.to(device), [w.to(device) for w in ws]


def _loss(bag, logits, mask):
    return (bag ** 2).sum() + 1e-3 * torch.where(
        mask[:, None], torch.tanh(logits), 0.0).sum()


def _pool_case(device, out):
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.parallel import collectives as C
    from acmil_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 2, device)
    feats, mask, ws = _inputs(device)
    half = N // 2
    x = feats[:, mesh.seq_index * half:(mesh.seq_index + 1) * half]
    m = mask[:, mesh.seq_index * half:(mesh.seq_index + 1) * half]
    x = x.contiguous().requires_grad_(True)
    wt = [w.clone().requires_grad_(True) for w in ws]
    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    bag, logits = ap.sharded_gated_attn_pool_grad(x, m, *wt, mesh.seq_group)
    share = (bag ** 2).sum() + C.psum(1e-3 * torch.where(
        m[:, None], torch.tanh(logits), 0.0).sum(), mesh.seq_group)
    share.backward()
    out["launches"] = (ap.fused_gated_attn_pool_batched.launches,
                       ap.fused_gated_attn_pool_bwd.launches)
    out.update(bag=bag.detach().cpu(), logits=logits.detach().cpu(),
               loss=float(share), d_feats=x.grad.float().cpu(),
               grads=[w.grad.cpu() for w in wt], seq_index=mesh.seq_index)


def _step_setup(device, mesh=None):
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import shard_params

    conf = Config.from_dict(dict(arch="ga", n_class=2, D_feat=DF, D_inner=L,
                                 n_token=K, n_masked_patch=10, mask_drop=0.6,
                                 lr=1e-3, seed=1, train_epoch=2))
    torch.manual_seed(1)
    model, fam = build_mil_model(conf, mesh=mesh)
    model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    state = create_train_state(model, conf, 4, family=fam)
    return model, state, make_train_step(model, conf, fam, mesh=mesh)


def _step_bag(device):
    from acmil_tpu_torch.data.bags import Bag

    feats, mask, _ = _inputs(device)
    gen = torch.Generator().manual_seed(1)
    u = torch.rand(B, K, N, generator=gen).to(device)
    return Bag(feats, mask, torch.zeros(B, N, 2, dtype=torch.int32,
                                        device=device),
               torch.tensor([1, 0, 1], device=device)), u


def _step_case(device, out):
    from acmil_tpu_torch.parallel import make_mesh, shard_bag

    mesh = make_mesh(1, 2, device)
    bag, u = _step_bag(device)
    model, state, step = _step_setup(device, mesh)
    aux = step(state, shard_bag(bag, mesh, shard_seq=True), stkim_u=u)
    out.update(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
               grads={n: p.grad.cpu() for n, p in model.named_parameters()})


def _rank_main(rank, store, out_dir):
    out = {}
    try:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        out["pool"], out["step"] = {}, {}
        _pool_case(device, out["pool"])
        _step_case(device, out["step"])
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("two ranks on the card need an NVIDIA card")
    tmp = str(tmp_path_factory.mktemp("gpu_mesh"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, os.path.join(tmp, "store"), tmp))
             for r in range(2)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    res = []
    for r in range(2):
        path = os.path.join(tmp, f"rank{r}.pt")
        assert os.path.exists(path), f"rank {r} wrote nothing"
        got = torch.load(path, weights_only=False)
        assert "error" not in got, got.get("error")
        res.append(got)
    return res


@pytest.mark.gpu
def test_sharded_pool_on_the_card_matches_one_process(ranks):
    from acmil_tpu_torch.ops import attn_pool as ap

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    feats, mask, ws = _inputs(device)
    x = feats.clone().requires_grad_(True)
    wt = [w.clone().requires_grad_(True) for w in ws]
    bag, logits = ap.gated_attn_pool_grad(x, mask, *wt)
    loss = _loss(bag, logits, mask)
    loss.backward()
    half = N // 2
    for got in ranks:
        p = got["pool"]
        assert p["launches"] == (1, 1)
        assert torch.isfinite(p["bag"]).all()
        torch.testing.assert_close(p["bag"], bag.detach().cpu(), rtol=0,
                                   atol=POOL_ATOL)
        assert torch.all(p["bag"][2] == 0)      # the all-masked bag
        cols = slice(p["seq_index"] * half, (p["seq_index"] + 1) * half)
        valid = mask[:, cols].cpu()[:, None]
        torch.testing.assert_close(
            torch.where(valid, p["logits"], 0.0),
            torch.where(valid, logits.detach().cpu()[..., cols], 0.0),
            rtol=0, atol=POOL_ATOL)
        np.testing.assert_allclose(p["loss"], float(loss.detach()), rtol=1e-4)
        torch.testing.assert_close(p["d_feats"],
                                   x.grad.float().cpu()[:, cols],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for g, w in zip(p["grads"], wt):
            torch.testing.assert_close(g, w.grad.cpu(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)


@pytest.mark.gpu
def test_sharded_acmil_step_on_the_card_matches_one_process(ranks):
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    bag, u = _step_bag(device)
    model, state, step = _step_setup(device)
    aux = step(state, bag, stkim_u=u)
    for got in ranks:
        s = got["step"]
        np.testing.assert_allclose(s["loss"], float(aux["loss"]),
                                   rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(s["grad_norm"], float(aux["grad_norm"]),
                                   rtol=1e-4)
        for n, p in model.named_parameters():
            want = p.grad.cpu()
            err = float((s["grads"][n] - want).abs().max())
            assert err <= STEP_GRAD_REL * float(want.abs().max()) \
                + STEP_GRAD_ATOL, (n, err)
