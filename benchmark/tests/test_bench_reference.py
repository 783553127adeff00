"""The plain references agree with the port's CPU route at tiny sizes (a
run of each kind reads ``correct``), and their controls, computed one
precision below the configuration's (TF32 for the f32 head, fp8 for the
bf16 trunk), are refused by the same limits."""

import pytest
import torch

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["train_vits16_acmil", "train_uni_acmil",
                                  "extract_uni"])
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    run = cell.kind_module().run(cell, 2 ** 31 + 11, 0.05, False, CPU)
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.failed == 0
    assert set(run.checks) == set(cell.limits)
    metric = "train_epoch_ms" if cell.kind == "train" else \
        "extract_patches_per_s"
    assert run.end_to_end[metric] > 0 and run.end_to_end["setup_s"] > 0


@pytest.mark.parametrize("name", ["train_vits16_acmil", "extract_uni"])
def test_control_is_refused(tiny_cell, name):
    from harness.checks import judge

    cell = tiny_cell(name)
    numbers = cell.kind_module().control(cell, 5, CPU)
    ok, checks = judge(numbers, cell.limits)
    assert not ok, checks
