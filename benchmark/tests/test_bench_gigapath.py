"""The ``extract_gigapath`` cell at a tiny size on the CPU: a sound run
reads ``correct``, its fp8 control is refused by its limits, and the
SwiGLU trunk's work counts (``flops/vit_swiglu.py``) match a count by
hand; on the card (``gpu``) a tiny run through the kernels reads
``correct``."""

import pytest
import torch

CPU = torch.device("cpu")


def test_sound_run_is_correct(tiny_cell):
    cell = tiny_cell("extract_gigapath")
    assert cell.config["trunk"]["act"] == "swiglu"
    run = cell.kind_module().run(cell, 2 ** 31 + 23, 0.05, False, CPU)
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.failed == 0
    assert set(run.checks) == set(cell.limits)
    assert run.end_to_end["extract_patches_per_s"] > 0


def test_control_is_refused(tiny_cell):
    from harness.checks import judge

    cell = tiny_cell("extract_gigapath")
    numbers = cell.kind_module().control(cell, 5, CPU)
    ok, checks = judge(numbers, cell.limits)
    assert not ok, checks


def test_swiglu_work_by_hand():
    from harness.spec import flops

    v = flops("vit_swiglu")
    n, d, h = 197, 1536, 8192
    # the patch embed over 196 patches, then 40 x (qkv, q k^T, p v, proj,
    # fc1 to 8192, fc2 from 4096)
    want = 2 * 196 * d * 768 + 40 * (
        2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
        + 2 * n * d * h + 2 * n * (h // 2) * d)
    assert v.flops_per_image(224, 16, d, 40, h) == want
    assert abs(want / 1e9 - 456.2) < 0.1
    # flops/vit.py's count of the same trunk has fc2 at the packed width
    old = flops("vit").flops_per_image(224, 16, d, 40, h)
    assert old - want == 40 * 2 * n * (h // 2) * d + 2 * d * 768
    ops, nbytes = v.linear_work(224, 16, d, 1, h, images=2)
    assert ops == 2 * 2 * n * (d * 3 * d + d * d + d * h + (h // 2) * d)
    assert nbytes == 2 * sum(m * k * 2 + k * o + m * w * 2 for m, k, o, w in
                             ((n, d, 3 * d, 3 * d), (n, d, d, d),
                              (n, d, h, h // 2), (n, h // 2, d, d)))
    ops, nbytes = v.fc1_work(224, 16, d, 40, h, images=3)
    assert ops == 40 * 3 * 2 * n * d * h
    assert nbytes == 2 * 40 * (3 * n * d + d * h + 3 * n * h // 2)


@pytest.mark.gpu
def test_tiny_run_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = tiny_cell("extract_gigapath")
    run = cell.kind_module().run(cell, 2 ** 31 + 29, 0.2, False,
                                 torch.device("cuda", 0))
    assert run.correct, run.checks
