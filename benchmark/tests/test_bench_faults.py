"""A run with the timed path broken underneath reads ``correct`` false,
for each fault its cell can have (``harness/faults.py``); the chip check
is skipped, the rest of a run is driven on the CPU at a tiny size."""

import pytest
import torch

from harness.faults import FAULTS, planted

CASES = [(cell, fault) for cell, kind in (("train_vits16_acmil", "train"),
                                          ("extract_uni", "extract"))
         for fault in FAULTS[kind]]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(tiny_cell, name, fault):
    cell = tiny_cell(name)
    with planted(cell.kind, fault):
        run = cell.kind_module().run(cell, 9, 0.05, False,
                                     torch.device("cpu"))
    assert not run.correct, (fault, run.checks)


def test_faults_are_taken_out_again(tiny_cell):
    from acmil_tpu_torch.engine import families
    from acmil_tpu_torch.models.encoders import fast

    before = (families.acmil_ga_apply_batched, fast.vit_encode,
              torch.optim.AdamW.step)
    for kind, faults in FAULTS.items():
        for fault in faults:
            with planted(kind, fault):
                pass
    assert (families.acmil_ga_apply_batched, fast.vit_encode,
            torch.optim.AdamW.step) == before


@pytest.mark.parametrize("dropped", ["train_chunk", "eval_group"])
def test_work_left_out_of_the_window_is_caught(tiny_cell, monkeypatch,
                                               dropped):
    """An epoch that steps or scores fewer bags than the cohort holds (a
    chunk of train bags, a group of eval bags left out) reads ``correct``
    false by the window's counts, though every set-up step is sound."""
    from acmil_tpu_torch.engine import train as engine

    cell = tiny_cell("train_vits16_acmil")
    if dropped == "train_chunk":
        real_train = engine.train_one_epoch_scanned

        def short_epoch(state, scan_step, loader, epoch, **kw):
            def skip_last(state, stacked, chunk, groups=None):
                if stacked is loader.device_groups()[-1]:
                    chunk = chunk[:-1]
                return scan_step(state, stacked, chunk, groups)
            return real_train(state, skip_last, loader, epoch, **kw)

        monkeypatch.setattr(engine, "train_one_epoch_scanned", short_epoch)
        gap = "step_count_gap"
    else:
        real_eval = engine.evaluate_scanned

        class Fewer:
            def __init__(self, loader):
                self.loader = loader

            def device_groups(self):
                return self.loader.device_groups()[:-1]

        monkeypatch.setattr(engine, "evaluate_scanned",
                            lambda step, loader, n_class, **kw: real_eval(
                                step, Fewer(loader), n_class, **kw))
        gap = "eval_count_gap"
    run = cell.kind_module().run(cell, 13, 0.05, False, torch.device("cpu"))
    assert not run.correct and run.checks[gap]["value"] > 0, run.checks
