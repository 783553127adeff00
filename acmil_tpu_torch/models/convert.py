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
``classifiers.{c}``; LBMIL's ``cls_w``/``cls_b`` become ``classifier``;
ILRA's three in-projection Dense layers become one stacked
``multihead_attn.in_proj_weight``; a LinearVDO's ``kernel``/``log_alp``
``[in, out]`` become ``weight``/``log_alp`` ``[out, in]``; a Nystrom
block's ``res_conv [H, k]`` becomes the conv weight ``[H, 1, k, 1]``, and
PPEG's ``proj7``/``proj5``/``proj3`` the reference's ``proj``/``proj1``/
``proj2``; DTFD's ``tier1_w``/``tier1_b`` become ``classifier.fc`` and its
tier-2 ``AttentionGated_1``/``Classifier1fc_0`` ``UClassifier.*``. The inverses are
``scripts/import_torch_checkpoint.py::convert_acmil_ga``,
``convert_acmil_mha``, ``convert_mha_single``, ``convert_dsmil``,
``convert_clam``, ``convert_mean_max``, ``convert_lbmil``,
``convert_attmil``, ``convert_ilra``, ``convert_bmil_vis`` and
``convert_ibmil`` (phase 1), ``convert_transmil`` and ``convert_mhim``
(both baselines, PPEG). IPS, ``bmil_enc``, ``bmil_spvis`` and phase-2
IBMIL and MHIM's PEG have no reference converter; their maps follow the
flax tree alone.
A frozen IBMIL dictionary is a constant of the flax module, not a
parameter, so its ``confounder_feat`` buffer is not in the returned dict.
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


def _gated(sd, prefix, ag):
    """An ``AttentionGated`` (``Dense_0..2``) at ``prefix``."""
    _linear(sd, f"{prefix}.attention_V.0", ag["Dense_0"])
    _linear(sd, f"{prefix}.attention_U.0", ag["Dense_1"])
    _linear(sd, f"{prefix}.attention_weights", ag["Dense_2"])


def _mean_max(params, droprate: float) -> Dict[str, torch.Tensor]:
    """``head.0`` and the head's last Linear, after a dropout (``head.3``)
    when ``droprate > 0``, else ``head.2``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "head.0", params["Dense_0"])
    _linear(sd, f"head.{3 if droprate > 0 else 2}", params["Dense_1"])
    return sd


def _lbmil(params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    _linear(sd, "classifier", {"kernel": params["cls_w"],
                               "bias": params["cls_b"]})
    return sd


def _attmil(params, arch: str) -> Dict[str, torch.Tensor]:
    """flax numbers Dense layers in construction order: the gated head's
    are stem, a, b, c, classifier; the ungated head builds its outer 1-unit
    Dense before the inner tanh Dense."""
    names = (("feature.0", "attention_a.0", "attention_b.0", "attention_c",
              "classifier.0") if arch == "attmil_gated" else
             ("feature.0", "attention.2", "attention.0", "classifier.0"))
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        _linear(sd, name, params[f"Dense_{i}"])
    return sd


def _ilra_mha(sd, prefix, p):
    for i, name in enumerate(("fc_q", "fc_k", "fc_v")):
        _linear(sd, f"{prefix}.{name}", p[f"Dense_{i}"])
    ins = [p[f"Dense_{i}"] for i in (3, 4, 5)]
    sd[f"{prefix}.multihead_attn.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(d["kernel"]).T for d in ins]))
    sd[f"{prefix}.multihead_attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(d["bias"]) for d in ins]))
    _linear(sd, f"{prefix}.multihead_attn.out_proj", p["Dense_6"])
    _linear(sd, f"{prefix}.fc_o", p["Dense_7"])
    for i in (0, 1):
        _layernorm(sd, f"{prefix}.ln{i}", p[f"LayerNorm_{i}"])
    if "Dense_8" in p:
        _linear(sd, f"{prefix}.gate.0", p["Dense_8"])


def _ilra(params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"GAB_{i}" in params:
        gab = params[f"GAB_{i}"]
        sd[f"gab_blocks.{i}.latent"] = _t(gab["latent"])
        _ilra_mha(sd, f"gab_blocks.{i}.project_forward", gab["_MHA_0"])
        _ilra_mha(sd, f"gab_blocks.{i}.project_backward", gab["_MHA_1"])
        i += 1
    sd["pooling.S"] = _t(params["NLP_0"]["seeds"])
    _ilra_mha(sd, "pooling.mha", params["NLP_0"]["_MHA_0"])
    _linear(sd, "classifier", params["Dense_0"])
    return sd


def _ips(params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    _gated(sd, "scorer", params["AttentionGated_0"])
    _gated(sd, "attention", params["AttentionGated_1"])
    _linear(sd, "classifier.fc", params["Classifier1fc_0"]["Dense_0"])
    return sd


def _ibmil(params) -> Dict[str, torch.Tensor]:
    """Phase 1, plus ``W_q``, ``W_k`` and a learned ``confounder_feat`` in
    phase 2."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    _gated(sd, "attention", params["AttentionGated_0"])
    _linear(sd, "classifier.fc", params["Classifier1fc_0"]["Dense_0"])
    for name in ("W_q", "W_k"):
        if name in params:
            _linear(sd, name, params[name])
    if "confounder_feat" in params:
        sd["confounder_feat"] = _t(params["confounder_feat"])
    return sd


def _vdo(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.log_alp"] = _t(np.asarray(p["log_alp"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bmil(params, arch: str, droprate: float) -> Dict[str, torch.Tensor]:
    """vis/enc: the gated net at ``attention_net.3`` after a dropout
    (``droprate > 0``), else ``attention_net.2``; spvis: ``fc`` and four
    LinearVDO layers."""
    sd: Dict[str, torch.Tensor] = {}
    if arch == "bmil_spvis":
        _linear(sd, "fc", params["Dense_0"])
        for i, name in enumerate(("attention_a", "attention_b",
                                  "attention_c", "classifiers")):
            _vdo(sd, name, params[f"LinearVDO_{i}"])
        return sd
    _linear(sd, "attention_net.0", params["Dense_0"])
    ang = f"attention_net.{3 if droprate > 0 else 2}"
    for i, name in enumerate(("attention_a.0", "attention_b.0",
                              "attention_c"), start=1):
        _linear(sd, f"{ang}.{name}", params[f"Dense_{i}"])
    _vdo(sd, "classifiers", params["LinearVDO_0"])
    return sd


def _nystrom_layer(sd, prefix, p):
    """A ``TransLayer`` (``LayerNorm_0``, ``NystromAttention_0``)."""
    _layernorm(sd, f"{prefix}.norm", p["LayerNorm_0"])
    ny = p["NystromAttention_0"]
    _linear(sd, f"{prefix}.attn.to_qkv", ny["Dense_0"])
    _linear(sd, f"{prefix}.attn.to_out.0", ny["Dense_1"])
    sd[f"{prefix}.attn.res_conv.weight"] = _t(
        np.asarray(ny["res_conv"])[:, None, :, None])


def _pos(sd, prefix, params):
    """``PPEG_0`` or ``PEG_0`` (SINCOS has no parameters)."""
    if "PPEG_0" in params:
        for flax_name, conv in (("proj7", "proj"), ("proj5", "proj1"),
                                ("proj3", "proj2")):
            sd[f"{prefix}.{conv}.weight"] = _t(params["PPEG_0"][flax_name])
            sd[f"{prefix}.{conv}.bias"] = _t(params["PPEG_0"][flax_name + "_b"])
    if "PEG_0" in params:
        sd[f"{prefix}.proj.weight"] = _t(params["PEG_0"]["proj"])
        sd[f"{prefix}.proj.bias"] = _t(params["PEG_0"]["proj_b"])


def _transmil(params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "_fc1.0", params["Dense_0"])
    sd["cls_token"] = _t(params["cls_token"])
    _nystrom_layer(sd, "layer1", params["TransLayer_0"])
    _pos(sd, "pos_layer", params)
    _nystrom_layer(sd, "layer2", params["TransLayer_1"])
    _layernorm(sd, "norm", params["LayerNorm_0"])
    _linear(sd, "_fc2", params["Dense_1"])
    return sd


def _mhim(params) -> Dict[str, torch.Tensor]:
    """``mhim`` and ``pure``: SAttention (any ``pos``) or DAttention."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "patch_to_emb.0", params["patch_to_emb"])
    _linear(sd, "predictor", params["predictor"])
    enc = "online_encoder"
    if "SAttentionEncoder_0" in params:
        sa = params["SAttentionEncoder_0"]
        sd[f"{enc}.cls_token"] = _t(sa["cls_token"])
        _nystrom_layer(sd, f"{enc}.layer1", sa["TransLayer_0"])
        _pos(sd, f"{enc}.pos_embedding", sa)
        _nystrom_layer(sd, f"{enc}.layer2", sa["TransLayer_1"])
        _layernorm(sd, f"{enc}.norm", sa["LayerNorm_0"])
        return sd
    da = params["DAttentionEncoder_0"]
    _linear(sd, f"{enc}.attention.attention.0", da["Dense_0"])
    _linear(sd, f"{enc}.attention.attention.2", da["Dense_1"])
    return sd


_ZOO = {
    "meanmil": lambda p, dr: _mean_max(p, dr),
    "maxmil": lambda p, dr: _mean_max(p, dr),
    "lbmil": lambda p, dr: _lbmil(p),
    "attmil": lambda p, dr: _attmil(p, "attmil"),
    "attmil_gated": lambda p, dr: _attmil(p, "attmil_gated"),
    "ilra": lambda p, dr: _ilra(p),
    "ips": lambda p, dr: _ips(p),
    "ibmil": lambda p, dr: _ibmil(p),
    "bmil_vis": lambda p, dr: _bmil(p, "bmil_vis", dr),
    "bmil_enc": lambda p, dr: _bmil(p, "bmil_enc", dr),
    "bmil_spvis": lambda p, dr: _bmil(p, "bmil_spvis", dr),
    "transmil": lambda p, dr: _transmil(p),
    "mhim": lambda p, dr: _mhim(p),
    "pure": lambda p, dr: _mhim(p),
    "dtfd": lambda p, dr: _dtfd(p),
}


def _dtfd(params) -> Dict[str, torch.Tensor]:
    """The reference's names (`tests/test_training_parity.py`'s DTFD map):
    ``dimReduction.fc1``, ``attention``, ``classifier.fc`` and
    ``UClassifier.{attention, classifier.fc}``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimReduction.fc1", params["DimReduction_0"]["Dense_0"])
    _gated(sd, "attention", params["AttentionGated_0"])
    _linear(sd, "classifier.fc", {"kernel": params["tier1_w"],
                                  "bias": params["tier1_b"]})
    _gated(sd, "UClassifier.attention", params["AttentionGated_1"])
    _linear(sd, "UClassifier.classifier.fc",
            params["Classifier1fc_0"]["Dense_0"])
    return sd


def _conv2d_vdo(params) -> Dict[str, torch.Tensor]:
    """A ``Conv2dVDO``'s HWIO ``kernel`` and ``log_alp`` → OIHW ``weight``
    and ``log_alp``."""
    return {name: _t(np.asarray(params[key]).transpose(3, 2, 0, 1))
            for name, key in (("weight", "kernel"), ("log_alp", "log_alp"))}


def _resnet_e2e(params, batch_stats) -> Dict[str, torch.Tensor]:
    """``ResnetE2EMIL``: the trunk through
    ``encoders/convert.py::resnet_from_flax`` under ``resnet.``, its three
    Dense layers (in construction order) as ``fc1``-``fc3``."""
    from acmil_tpu_torch.models.encoders.convert import resnet_from_flax

    if batch_stats is None:
        raise ValueError("resnet_e2e needs the flax batch_stats too")
    trunk = next(k for k in params if k.startswith("ResNet"))
    sd = {f"resnet.{k}": v for k, v in resnet_from_flax(
        params[trunk], batch_stats[trunk]).items()}
    dense = sorted((k for k in params if k.startswith("Dense")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, k in enumerate(dense):
        _linear(sd, f"fc{i + 1}", params[k])
    return sd


def from_jax_params(params, arch: str, droprate: float = 0.25,
                    batch_stats=None) -> Dict[str, torch.Tensor]:
    """``arch`` is ``"ga"`` (ACMIL_GA), ``"mha"`` (ACMIL_MHA), ``"abmil"``,
    ``"mha_single"`` (MHA), ``"dsmil"``, ``"clam_sb"``, ``"clam_mb"``, an
    arch of the generic zoo (``"meanmil"``, ``"maxmil"``, ``"lbmil"``,
    ``"attmil"``, ``"attmil_gated"``, ``"ilra"``, ``"ips"``, ``"ibmil"``,
    ``"bmil_vis"``, ``"bmil_enc"``, ``"bmil_spvis"``, ``"transmil"``,
    ``"mhim"``, ``"pure"``), ``"dtfd"``, ``"vit"`` (a patch
    encoder of ``acmil_tpu.models.encoders.vit``), ``"conv2d_vdo"`` (one
    ``Conv2dVDO``) or ``"resnet_e2e"`` (``ResnetE2EMIL``, which needs the
    flax ``batch_stats`` too). ``droprate`` places the
    layer after a dropout in CLAM's attention net, mean/max's head and
    BMIL vis/enc's attention net."""
    if arch == "vit":
        return _vit(params)
    if arch == "conv2d_vdo":
        return _conv2d_vdo(params)
    if arch == "resnet_e2e":
        return _resnet_e2e(params, batch_stats)
    if arch in ("clam_sb", "clam_mb"):
        return _clam(params, droprate)
    if arch == "dsmil":
        return _dsmil(params)
    if arch in ("mha", "mha_single"):
        return _mha(params, arch)
    if arch in _ZOO:
        return _ZOO[arch](params, droprate)
    if arch not in ("ga", "abmil"):
        raise ValueError(f"no converter for arch {arch!r} (have 'ga', 'mha', "
                         f"'abmil', 'mha_single', 'dsmil', 'clam_sb', "
                         f"'clam_mb', {', '.join(map(repr, _ZOO))}, 'vit', "
                         f"'conv2d_vdo', 'resnet_e2e')")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimreduction.fc1", params["DimReduction_0"]["Dense_0"])
    _gated(sd, "attention", params["AttentionGated_0"])
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
