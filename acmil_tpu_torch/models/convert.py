"""Weights across the two packages: a flax parameter tree of
``acmil_tpu.models.acmil`` or of an ``encoders.vit.ViT`` (as numpy arrays) →
the port's ``state_dict``.

flax kernels are ``[in, out]``, torch weights ``[out, in]``; ACMIL_GA's
stacked branch classifiers ``branch_w [K, L, C]`` / ``branch_b [K, C]``
become ``classifier.{k}.fc.*``, and ACMIL_MHA's vmapped branch module
(a leading K axis on every parameter) becomes ``sub_attention.{k}.*``;
DSMIL's dense ``fcc_w [C, C·D]`` becomes the Conv1d weight
``b_classifier.fcc.weight [C, C, D]``; CLAM's stacked ``inst_w [C, L, 2]``
and MB's ``bag_w [C, L]`` become ``instance_classifiers.{c}`` and
``classifiers.{c}``. The inverses are
``scripts/import_torch_checkpoint.py::convert_acmil_ga``,
``convert_acmil_mha``, ``convert_mha_single``, ``convert_dsmil`` and
``convert_clam``.
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


def _layernorm(sd, prefix, ln):
    sd[f"{prefix}.weight"] = _t(ln["scale"])
    sd[f"{prefix}.bias"] = _t(ln["bias"])


def _vit(params) -> Dict[str, torch.Tensor]:
    """A flax ``encoders.vit.ViT`` tree → the port's ViT state dict:
    ``patch_embed`` HWIO → OIHW, ``block{i}`` → ``blocks.{i}`` with
    ``Dense_0``/``Dense_1`` → ``mlp.fc1``/``mlp.fc2`` (any widths, so SwiGLU's
    too), ``ls1``/``ls2`` → ``ls{1,2}.gamma``, and ``norm_pre`` and
    ``proj_out`` where present."""
    pe = params["patch_embed"]
    sd = {"patch_embed.proj.weight": _t(np.asarray(pe["kernel"])
                                        .transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": _t(pe["bias"]),
          "cls_token": _t(params["cls_token"]),
          "pos_embed": _t(params["pos_embed"])}
    for name in ("norm_pre", "norm"):
        if name in params:
            _layernorm(sd, name, params[name])
    if "proj_out" in params:
        _linear(sd, "proj_out", params["proj_out"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk, pre = params[f"block{i}"], f"blocks.{i}"
        _layernorm(sd, f"{pre}.norm1", blk["norm1"])
        _layernorm(sd, f"{pre}.norm2", blk["norm2"])
        _linear(sd, f"{pre}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", blk["attn"]["proj"])
        _linear(sd, f"{pre}.mlp.fc1", blk["mlp"]["Dense_0"])
        _linear(sd, f"{pre}.mlp.fc2", blk["mlp"]["Dense_1"])
        for ls in ("ls1", "ls2"):
            if ls in blk:
                sd[f"{pre}.{ls}.gamma"] = _t(blk[ls])
    return sd


def _dsmil(params) -> Dict[str, torch.Tensor]:
    """The registered DSMIL build (``nonlinear=False``, ``passing_v=False``):
    ``Dense_0`` is the instance classifier, ``Dense_1`` the query map."""
    if set(params) != {"Dense_0", "Dense_1", "fcc_w", "fcc_b"}:
        raise ValueError("only the nonlinear=False, passing_v=False DSMIL "
                         f"tree converts; got keys {sorted(params)}")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "i_classifier.fc.0", params["Dense_0"])
    _linear(sd, "b_classifier.q", params["Dense_1"])
    w = np.asarray(params["fcc_w"])
    sd["b_classifier.fcc.weight"] = _t(w.reshape(w.shape[0], w.shape[0], -1))
    sd["b_classifier.fcc.bias"] = _t(params["fcc_b"])
    return sd


def _clam(params, droprate: float) -> Dict[str, torch.Tensor]:
    """CLAM_SB (``Dense_1``) or CLAM_MB (``bag_w``/``bag_b``); the attention
    net sits at ``attention_net.3`` after a dropout (``droprate > 0``), else
    at ``attention_net.2``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "attention_net.0", params["Dense_0"])
    ang = f"attention_net.{3 if droprate > 0 else 2}"
    ag = params["AttnNetGated_0"]
    _linear(sd, f"{ang}.attention_a.0", ag["Dense_0"])
    _linear(sd, f"{ang}.attention_b.0", ag["Dense_1"])
    _linear(sd, f"{ang}.attention_c", ag["Dense_2"])
    if "Dense_1" in params:
        _linear(sd, "classifiers", params["Dense_1"])
    else:
        for c, (w, b) in enumerate(zip(np.asarray(params["bag_w"]),
                                       np.asarray(params["bag_b"]))):
            sd[f"classifiers.{c}.weight"] = _t(w[None])
            sd[f"classifiers.{c}.bias"] = _t(b[None])
    for c, (w, b) in enumerate(zip(np.asarray(params["inst_w"]),
                                   np.asarray(params["inst_b"]))):
        sd[f"instance_classifiers.{c}.weight"] = _t(w.T)
        sd[f"instance_classifiers.{c}.bias"] = _t(b)
    return sd


_MHA_DENSES = ("q_proj", "k_proj", "v_proj", "out_proj")


def _mha_module(sd, prefix, p):
    """A flax ``MultiHeadAttention`` (``Dense_0..3``, ``LayerNorm_0``)."""
    for i, name in enumerate(_MHA_DENSES):
        _linear(sd, f"{prefix}.{name}", p[f"Dense_{i}"])
    _layernorm(sd, f"{prefix}.layer_norm", p["LayerNorm_0"])


def _mha(params, arch: str) -> Dict[str, torch.Tensor]:
    """ACMIL_MHA (``"mha"``) or MHA (``"mha_single"``)."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    sd["q"] = _t(params["q"])
    cls = params["Classifier1fc_0"]["Dense_0"]
    if arch == "mha_single":
        _mha_module(sd, "attention", params["MultiHeadAttention_0"])
        _linear(sd, "classifier.fc", cls)
        return sd
    vm = _unstack(params["VmapMultiHeadAttention_0"])
    for k, branch in enumerate(vm):
        _mha_module(sd, f"sub_attention.{k}", branch)
    bag = params["BagAttention_0"]
    _linear(sd, "bag_attention.v_proj", bag["Dense_0"])
    _linear(sd, "bag_attention.out_proj", bag["Dense_1"])
    _layernorm(sd, "bag_attention.layer_norm", bag["LayerNorm_0"])
    for k, (w, b) in enumerate(zip(np.asarray(params["branch_w"]),
                                   np.asarray(params["branch_b"]))):
        sd[f"classifier.{k}.fc.weight"] = _t(w.T)
        sd[f"classifier.{k}.fc.bias"] = _t(b)
    _linear(sd, "Slide_classifier.fc", cls)
    return sd


def _unstack(tree) -> list:
    """A nested dict of arrays with a leading K axis → K dicts, one per
    index of that axis."""
    def leaves(t, k):
        return {n: leaves(v, k) if isinstance(v, dict) else np.asarray(v)[k]
                for n, v in t.items()}

    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [leaves(tree, k) for k in range(np.asarray(first).shape[0])]


def from_jax_params(params, arch: str,
                    droprate: float = 0.25) -> Dict[str, torch.Tensor]:
    """``arch`` is ``"ga"`` (ACMIL_GA), ``"mha"`` (ACMIL_MHA), ``"abmil"``,
    ``"mha_single"`` (MHA), ``"dsmil"``, ``"clam_sb"``, ``"clam_mb"`` or
    ``"vit"`` (a patch encoder of ``acmil_tpu.models.encoders.vit``).
    ``droprate`` is CLAM's, which places its attention net."""
    if arch == "vit":
        return _vit(params)
    if arch in ("clam_sb", "clam_mb"):
        return _clam(params, droprate)
    if arch == "dsmil":
        return _dsmil(params)
    if arch in ("mha", "mha_single"):
        return _mha(params, arch)
    if arch not in ("ga", "abmil"):
        raise ValueError(f"no converter for arch {arch!r} (have 'ga', 'mha', "
                         f"'abmil', 'mha_single', 'dsmil', 'clam_sb', "
                         f"'clam_mb', 'vit')")
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
