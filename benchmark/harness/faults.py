"""Faults planted under the timed path, to show that a run carrying one
reads ``correct`` false (``benchmark/tests/test_bench_faults.py`` on the
CPU; ``benchmark/tools/readings.py --mode <fault>`` on the card). Never
used by a benchmark run.

- ``unchanged_state`` (train): the optimizer's step does nothing;
- ``half_batch``: half of the work left out and the rest taken for the
  whole: a bag's second half of valid patches out of the pooling (train),
  a batch's second half of images not encoded, the first half's features
  returned in their place (extract);
- ``altered_answer``: an answer altered where it is produced: the slide
  logit of class 0 raised by 0.5 in training (train), each batch's
  features shifted by one row (extract).

The exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"train": ("unchanged_state", "half_batch", "altered_answer"),
          "extract": ("half_batch", "altered_answer")}


def _first_half(mask: torch.Tensor) -> torch.Tensor:
    count = mask.sum(dim=-1, keepdim=True)
    return mask & (mask.cumsum(dim=-1) <= (count + 1) // 2)


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def planted(kind: str, fault: str):
    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for kind {kind!r}")
    if kind == "train":
        if fault == "unchanged_state":
            with _patched(torch.optim.AdamW, "step",
                          lambda self, closure=None: None):
                yield
            return
        from acmil_tpu_torch.engine import families

        real = families.acmil_ga_apply_batched

        def wrapped(model, feats, mask, *args, **kw):
            training = kw.get("stkim_generator") is not None
            if training and fault == "half_batch":
                mask = _first_half(mask)
            sub, slide, logits = real(model, feats, mask, *args, **kw)
            if training and fault == "altered_answer":
                slide = slide + torch.nn.functional.one_hot(
                    torch.zeros((), dtype=torch.long, device=slide.device),
                    slide.shape[-1]).to(slide.dtype) * 0.5
            return sub, slide, logits

        with _patched(families, "acmil_ga_apply_batched", wrapped):
            yield
        return
    from acmil_tpu_torch.models.encoders import fast

    real_encode = fast.vit_encode

    def encode(params, images, **kw):
        if fault == "half_batch":
            half = real_encode(params, images[:(images.shape[0] + 1) // 2],
                               **kw)
            return torch.cat([half, half])[:images.shape[0]]
        return torch.roll(real_encode(params, images, **kw), 1, dims=0)

    with _patched(fast, "vit_encode", encode):
        yield
