"""The scanned epoch of every arch of the port's registry, with and without
SAM, on the CPU: what a CUDA graph of the step needs, checked before a card
sees it, and MHIM's scanned epoch against the JAX package's.

A capture makes ``torch.cuda.graph`` raise at the first host read or host
copy inside the step. On the CPU nothing raises, so :func:`no_host_reads`
makes the same reads raise while a scanned train step and a scanned eval
step of each arch run: ``Tensor.item``, ``__bool__``, ``__int__``,
``__float__``, ``__index__``, ``tolist``, ``numpy`` and ``cpu``, and
``torch.tensor``/``torch.as_tensor`` given a ``device``. The optimizer's
step is torch's own (``capturable`` on a card) and runs outside it.
``tests/test_torch_gpu_scan_epoch.py`` captures the same steps on a card.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data.loader import BagLoader as JaxBagLoader
from acmil_tpu.engine.train import create_train_state as jax_create_state
from acmil_tpu.engine.train import make_scan_train_step as jax_make_scan
from acmil_tpu.engine.train import \
    train_one_epoch_scanned as jax_train_scanned
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import BagLoader
from acmil_tpu_torch.engine.train import (EAGER_SCAN_REASONS,
                                          GRAPH_SCAN_ARCHS, DeviceSchedule,
                                          create_train_state,
                                          make_scan_eval_step,
                                          make_scan_train_step,
                                          train_one_epoch_scanned)
from acmil_tpu_torch.models import _REGISTRY, build_mil_model, fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.parallel.mesh import DrawTape, draw
from tests.test_scan_epoch import _ListSource

# the archs whose step runs B1 and B2 (fused) or B6 (eval): with SAM too
SAM_ARCHS = ("ga", "mha", "abmil", "clam_sb", "clam_mb", "dsmil", "dtfd",
             "mha_single", "transmil", "bmil_vis")
CASES = sorted(_REGISTRY) + [a + "+sam" for a in SAM_ARCHS] + ["dtfd+fused"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread at these tiny shapes: the lane's workers share
    the cores, and PyTorch's thread pools oversubscribed them (the TransMIL
    loop case took minutes there against a second alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HostRead(AssertionError):
    """A read or copy a CUDA graph capture refuses."""


_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist",
          "numpy", "cpu")
_suspended = [0]


@contextlib.contextmanager
def allowed():
    """Within :func:`no_host_reads`: reads allowed again."""
    _suspended[0] += 1
    try:
        yield
    finally:
        _suspended[0] -= 1


@contextlib.contextmanager
def no_host_reads():
    """While it is open, a host read of a tensor raises :class:`HostRead`,
    and so does ``torch.tensor``/``torch.as_tensor`` with a ``device``."""
    saved = {name: torch.Tensor.__dict__.get(name) for name in _READS}
    real = {"tensor": torch.tensor, "as_tensor": torch.as_tensor}

    def refusing(name, fn):
        def read(*args, **kwargs):
            if not _suspended[0]:
                raise HostRead(f"Tensor.{name} inside the step")
            return fn(*args, **kwargs)
        return read

    def making(name):
        def make(*args, **kwargs):
            if kwargs.get("device") is not None and not _suspended[0]:
                raise HostRead(f"torch.{name}(..., device=...) inside the "
                               f"step: a copy to the device")
            return real[name](*args, **kwargs)
        return make

    for name in _READS:
        setattr(torch.Tensor, name, refusing(name, getattr(torch.Tensor,
                                                           name)))
    torch.tensor, torch.as_tensor = making("tensor"), making("as_tensor")
    try:
        yield
    finally:
        torch.tensor, torch.as_tensor = real["tensor"], real["as_tensor"]
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def _conf(case, **kw):
    arch, _, opt = case.partition("+")
    fused = arch in ("ga", "clam_sb", "clam_mb") or opt == "fused"
    d = dict(arch=arch, n_class=2, D_feat=32, D_inner=16, n_token=3,
             n_masked_patch=5, mask_drop=0.5, lr=1e-3, wd=1e-4,
             train_epoch=3, min_bucket=64, seed=0,
             droprate=0.0 if fused else 0.25, dropout=0.25, mlp_dim=16,
             mask_ratio=0.1, mask_ratio_h=0.2, mask_ratio_hr=0.5, mm=0.9,
             mm_sche=True, mrh_sche=True, steps_per_epoch=20, ips_m=16,
             numGroup=4, total_instance=4, use_sam=opt == "sam")
    d.update(kw)
    return Config.from_dict(d)


def _group_loader(slides, **kw):
    return BagLoader(_ListSource(slides), 1, min_bucket=64, seed=0, **kw)


def test_every_arch_has_a_scanned_route():
    assert set(GRAPH_SCAN_ARCHS) | set(EAGER_SCAN_REASONS) == set(_REGISTRY)
    assert not set(GRAPH_SCAN_ARCHS) & set(EAGER_SCAN_REASONS)


@pytest.mark.parametrize("case", CASES)
def test_scanned_steps_make_no_host_read(synthetic_slides, case,
                                         monkeypatch):
    """Two scanned train steps and one scanned eval of a group, each under
    :func:`no_host_reads`, with the rate and the step count from a
    ``DeviceSchedule`` as on a card: nothing in the body reads the host."""
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)           # CLAM, DSMIL: B1/B6
    if case == "dtfd+fused":
        monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", 0)
    conf = _conf(case)
    torch.manual_seed(0)
    model, family = build_mil_model(conf)
    loader = _group_loader(synthetic_slides, shuffle=False)
    groups = loader.device_groups()
    group = max(groups, key=lambda g: int(g.label.shape[0]))
    state = create_train_state(model, conf, len(loader), family=family)
    scan = make_scan_train_step(model, conf, family)
    scan.device_lr = True                 # the card's DeviceSchedule
    run, record = scan._run, scan._record

    def guarded(fn):
        def call(*args):
            with no_host_reads():
                return fn(*args)
        return call

    scan._run, scan._record = guarded(run), guarded(record)
    opt_step = state.opt.step

    def stepping(*args, **kwargs):
        with allowed():
            return opt_step(*args, **kwargs)

    state.opt.step = stepping
    before = [p.detach().clone() for p in model.parameters()]
    sums = scan(state, group, [0, 1], groups)
    assert isinstance(scan.sched, DeviceSchedule)
    assert state.step == 2 and int(scan.sched.step) == 2
    assert all(np.isfinite(float(v)) for v in sums.values())
    assert any(not torch.equal(p, q) for p, q in
               zip(model.parameters(), before))
    scan_eval = make_scan_eval_step(model, family)
    scan_eval.step = guarded(scan_eval.step)
    probs = scan_eval(group)
    assert probs.shape == (int(group.label.shape[0]), 1, conf.n_class)
    assert torch.isfinite(probs).all()


def test_no_host_reads_catches_each_read():
    x = torch.ones(2)
    reads = [lambda: x.sum().item(), lambda: bool(x.any()),
             lambda: int(x[0]), lambda: float(x[0]), lambda: x.tolist(),
             lambda: x.numpy(), lambda: range(10)[x.long()[0]],
             lambda: x.cpu(), lambda: torch.tensor(1.0, device="cpu"),
             lambda: torch.as_tensor([1.0], device="cpu")]
    with no_host_reads():
        for read in reads:
            with pytest.raises(HostRead):
                read()
        with allowed():
            assert x.sum().item() == 2.0
        torch.tensor(1.0)                              # on the host: allowed
    assert x.sum().item() == 2.0 and bool(x.all())     # all put back


def test_draw_tape_hands_the_first_pass_draws_to_the_second():
    gen = torch.Generator().manual_seed(3)
    tape = DrawTape()
    with tape.recording():
        a = (draw((2, 5), gen, "cpu"), draw((3,), gen, "cpu", normal=True))
    state = gen.get_state()
    with tape.replaying():
        b = (draw((2, 5), gen, "cpu"), draw((3,), gen, "cpu", normal=True))
    assert all(x is y for x, y in zip(a, b))
    assert torch.equal(gen.get_state(), state)        # drew once
    with pytest.raises(RuntimeError, match="is"):
        with tape.replaying():
            draw((2, 4), gen, "cpu")
    with pytest.raises(RuntimeError, match="took 1 of the 2"):
        with tape.replaying():
            draw((2, 5), gen, "cpu")
    assert not torch.equal(draw((2, 5), gen, "cpu"), a[0])


# ---------------------------------------------------------------------------
# MHIM's scanned epoch, teacher included, against the JAX package's
# ---------------------------------------------------------------------------

def test_mhim_scanned_epoch_matches_jax(synthetic_slides):
    """One scanned epoch of each package from the same student and teacher,
    the EMA momentum and the high-attention ratio on their cosine
    schedules, masking without draws (dropout 0, ``mask_ratio_hr`` 1): the
    epoch's mean losses to 1e-4 relative, student and teacher to n·lr
    absolute (the bounds of tests/test_torch_scan_epoch.py::
    test_scanned_epoch_matches_jax)."""
    src = _ListSource(synthetic_slides)
    kw = dict(batch_size=1, min_bucket=64, seed=0, shuffle=True)
    jl, pl = JaxBagLoader(src, **kw), BagLoader(src, **kw)
    n = len(pl)
    d = dict(arch="mhim", n_class=2, D_feat=32, mlp_dim=16, baseline="attn",
             da_act="gelu", dropout=0.0, lr=1e-3, wd=1e-4, train_epoch=2,
             steps_per_epoch=n, seed=0, mask_ratio_l=0.2, mask_ratio_h=0.3,
             mask_ratio_hr=1.0, mm=0.9, mm_sche=True, mrh_sche=True,
             min_bucket=64)
    jconf, conf = JaxConfig.from_dict(d), Config.from_dict(d)
    jm, jfam = jax_build_model(jconf)
    example = jax.tree_util.tree_map(lambda t: t[0], jl.device_groups()[0])
    jstate = jax_create_state(jm, jconf, jax.random.PRNGKey(0), example, n,
                              family=jfam)
    tree = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t),
                                     "mhim")
    model, family = build_mil_model(conf)
    model.load_state_dict(tree(jstate.params))
    state = create_train_state(model, conf, n, family=family)
    state.teacher.load_state_dict(tree(jstate.teacher_params))
    jstate, jstats = jax_train_scanned(
        jstate, jax_make_scan(jm, jconf, jfam), jl, jax.random.PRNGKey(1), 0)
    _, stats = train_one_epoch_scanned(
        state, make_scan_train_step(model, conf, family), pl, 0)
    assert state.step == int(jstate.step) == n
    for k in ("loss", "logit_loss", "cls_loss"):
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-4, err_msg=k)
    want, want_t = tree(jstate.params), tree(jstate.teacher_params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=n * conf.lr, rtol=0, err_msg=name)
        np.testing.assert_allclose(
            state.teacher.get_parameter(name).detach().numpy(),
            want_t[name].numpy(), atol=n * conf.lr, rtol=0,
            err_msg="teacher " + name)
    # the teacher moved, and lags the student
    for name, p in model.named_parameters():
        t = state.teacher.get_parameter(name)
        assert not torch.equal(t, p), name
