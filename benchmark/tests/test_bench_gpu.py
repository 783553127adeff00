"""On the card: a run of each kind at a tiny size through the kernels and
the graph route reads ``correct`` (``python -m pytest benchmark/tests -m
gpu`` on the card; skipped without one)."""

import pytest
import torch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["train_vits16_acmil", "extract_uni"])
def test_tiny_run_on_the_card(tiny_cell, name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = tiny_cell(name)
    run = cell.kind_module().run(cell, 21, 0.2, False,
                                 torch.device("cuda", 0))
    assert run.correct, run.checks
