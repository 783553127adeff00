"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
harness, its generators, its work counts, its references and their
controls, and its faults, at tiny sizes on the CPU. Tests marked ``gpu``
need a card and decide inside the test whether there is one."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def tiny(cell):
    """A cell cut to a size the CPU runs in seconds: the train mix's cohort
    to 5 + 2 + 2 bags of 200-1500 patches, the trunk to two blocks (see
    ``cut_trunks``) and batches of two images. Widths stay as configured."""
    c = copy.deepcopy(cell)
    if c.kind == "train":
        c.traffic.update(bags={"train": 5, "val": 2, "test": 2},
                         min_bucket=256)
        c.traffic["lengths"].update(min=200, max=1500, mean=700)
    else:
        c.config["trunk"].update(depth=TINY_DEPTH, batch_size=2)
        c.traffic.update(pool_batches=2, batches_per_slide=2, check_rows=4,
                         reference_block=2)
    return c


TINY_DEPTH = 2


def cut_trunks(monkeypatch) -> None:
    """The program's trunks built with their first ``TINY_DEPTH`` blocks,
    as the tiny cells' configurations state (the harness refuses a trunk
    whose depth is not the configuration's)."""
    import dataclasses

    from acmil_tpu_torch.models.encoders import build

    def cut(builder):
        def make(dtype):
            enc = builder(dtype)
            enc.blocks = enc.blocks[:TINY_DEPTH]
            enc.depth = TINY_DEPTH
            return enc
        return make

    for key, spec in list(build.ENCODER_SPECS.items()):
        if spec.converter != "vit":
            continue
        monkeypatch.setitem(build.ENCODER_SPECS, key, dataclasses.replace(
            spec, builder=cut(spec.builder), depth=TINY_DEPTH))


@pytest.fixture
def load():
    from harness.spec import load_cell

    return lambda name: load_cell(ROOT, name)


@pytest.fixture
def tiny_cell(load, monkeypatch):
    cut_trunks(monkeypatch)
    return lambda name: tiny(load(name))
