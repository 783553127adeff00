"""Weights across the two packages: a flax parameter tree of
``acmil_tpu.models.acmil`` (as numpy arrays) → the port's ``state_dict``.

flax kernels are ``[in, out]``, torch weights ``[out, in]``; ACMIL_GA's
stacked branch classifiers ``branch_w [K, L, C]`` / ``branch_b [K, C]``
become ``classifier.{k}.fc.*``. The inverse is
``scripts/import_torch_checkpoint.py::convert_acmil_ga``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, dense):
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        sd[f"{prefix}.bias"] = _t(dense["bias"])


def from_jax_params(params, arch: str) -> Dict[str, torch.Tensor]:
    """``arch`` is ``"ga"`` (ACMIL_GA) or ``"abmil"``."""
    if arch not in ("ga", "abmil"):
        raise ValueError(f"no converter for arch {arch!r} (have 'ga', 'abmil')")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    ag = params["AttentionGated_0"]
    _linear(sd, "attention.attention_V.0", ag["Dense_0"])
    _linear(sd, "attention.attention_U.0", ag["Dense_1"])
    _linear(sd, "attention.attention_weights", ag["Dense_2"])
    cls = params["Classifier1fc_0"]["Dense_0"]
    if arch == "abmil":
        _linear(sd, "classifier.fc", cls)
        return sd
    for k, (w, b) in enumerate(zip(np.asarray(params["branch_w"]),
                                   np.asarray(params["branch_b"]))):
        sd[f"classifier.{k}.fc.weight"] = _t(w.T)
        sd[f"classifier.{k}.fc.bias"] = _t(b)
    _linear(sd, "Slide_classifier.fc", cls)
    return sd
