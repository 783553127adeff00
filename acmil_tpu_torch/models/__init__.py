"""MIL model dispatch, the port of ``acmil_tpu/models/__init__.py``.

A registry from arch name to ``(factory(conf) -> nn.Module, family)``,
where ``family`` keys into :mod:`acmil_tpu_torch.engine.families`. The
port registers ``ga`` (ACMIL_GA), ``mha`` (ACMIL_MHA), ``abmil``,
``mha_single`` (MHA), ``dsmil``, ``clam_sb`` and ``clam_mb`` (CLAM), and
the rest of the generic zoo: ``meanmil``, ``maxmil``, ``lbmil``,
``attmil``, ``attmil_gated``, ``ilra``, ``ips``, ``ibmil`` (phase 2 when the
config names ``c_path``), ``bmil_vis``, ``bmil_enc`` and ``bmil_spvis``
(family ``bmil``), ``transmil`` (``transmil_pad_mode`` zero or wrap,
``compute_dtype`` float32 or bfloat16), and MHIM's two stages, ``mhim``
(family ``mhim``) and ``pure`` (family ``pure``), and ``dtfd`` (family
``dtfd``: ``numGroup``, ``total_instance``, ``distill`` and ``droprate``
from the config), with the JAX registry's families. Every head draws its
initial weights from a ``torch.Generator`` seeded with ``conf.seed``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from acmil_tpu_torch.models.acmil import ABMIL, ACMIL_GA, ACMIL_MHA, MHA
from acmil_tpu_torch.models.attmil import DAttentionMIL
from acmil_tpu_torch.models.bmil import BMILSpvis, BMILVis
from acmil_tpu_torch.models.clam import CLAM_MB, CLAM_SB
from acmil_tpu_torch.models.dsmil import DSMIL
from acmil_tpu_torch.models.dtfd import DTFD
from acmil_tpu_torch.models.ibmil import IBMIL
from acmil_tpu_torch.models.ilra import ILRA
from acmil_tpu_torch.models.ips import IPSNet
from acmil_tpu_torch.models.lbmil import LBMIL
from acmil_tpu_torch.models.mean_max import MaxMIL, MeanMIL
from acmil_tpu_torch.models.mhim import MHIM
from acmil_tpu_torch.models.transmil import TransMIL

_REGISTRY: Dict[str, Tuple[Callable, str]] = {}


def register_model(name: str, family: str = "default"):
    def deco(factory):
        _REGISTRY[name] = (factory, family)
        return factory

    return deco


@register_model("abmil")
def _abmil(conf):
    return ABMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner)


@register_model("mha_single")
def _mha(conf):
    return MHA(n_class=conf.n_class, d_feat=conf.D_feat, d_inner=conf.D_inner)


@register_model("ga", family="acmil")
def _acmil_ga(conf):
    return ACMIL_GA(
        n_class=conf.n_class,
        d_feat=conf.D_feat,
        d_inner=conf.D_inner,
        n_token=conf.n_token,
        n_masked_patch=conf.n_masked_patch,
        mask_drop=conf.mask_drop,
    )


@register_model("mha", family="acmil")
def _acmil_mha(conf):
    return ACMIL_MHA(
        n_class=conf.n_class,
        d_feat=conf.D_feat,
        d_inner=conf.D_inner,
        n_token=conf.n_token,
        n_masked_patch=conf.n_masked_patch,
        mask_drop=conf.mask_drop,
    )


@register_model("dsmil", family="dsmil")
def _dsmil(conf):
    # the generic trainer builds BClassifier(nonlinear=False)
    # (Step3_WSI_classification.py:129-131)
    return DSMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, nonlinear=False)


def _gen(conf) -> torch.Generator:
    return torch.Generator().manual_seed(int(conf.seed))


def _clam(cls, conf):
    # droprate configurable, so that `droprate: 0` takes the fused training
    # route (the reference default is dropout 0.25, `clam.py:86`); k_sample
    # and subtyping as the family reads them, so both routes agree
    return cls(n_class=conf.n_class, d_feat=conf.D_feat, d_inner=conf.D_inner,
               k_sample=int(getattr(conf, "k_sample", 8)),
               droprate=float(getattr(conf, "droprate", 0.25)),
               subtyping=getattr(conf, "subtyping", None),
               inst_loss=str(getattr(conf, "inst_loss", "ce")),
               generator=_gen(conf))


@register_model("clam_sb", family="clam")
def _clam_sb(conf):
    return _clam(CLAM_SB, conf)


@register_model("clam_mb", family="clam")
def _clam_mb(conf):
    return _clam(CLAM_MB, conf)


@register_model("meanmil")
def _mean(conf):
    return MeanMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                   d_inner=conf.D_inner, generator=_gen(conf))


@register_model("maxmil")
def _max(conf):
    return MaxMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                  d_inner=conf.D_inner, generator=_gen(conf))


@register_model("lbmil")
def _lbmil(conf):
    return LBMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, generator=_gen(conf))


@register_model("attmil")
def _attmil(conf):
    return DAttentionMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                         generator=_gen(conf))


@register_model("attmil_gated")
def _attmil_gated(conf):
    return DAttentionMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                         gated=True, generator=_gen(conf))


@register_model("ilra")
def _ilra(conf):
    return ILRA(n_class=conf.n_class, d_feat=conf.D_feat,
                generator=_gen(conf))


@register_model("ips")
def _ips(conf):
    return IPSNet(n_class=conf.n_class, d_feat=conf.D_feat,
                  d_inner=conf.D_inner,
                  m_keep=int(getattr(conf, "ips_m", 256)),
                  generator=_gen(conf))


def _confounders(conf):
    """The phase-2 dictionary ``[P, D_inner]`` from ``conf.c_path`` (one
    ``.npy`` path or a list, concatenated), or None (phase 1)."""
    c_path = getattr(conf, "c_path", None)
    if not c_path:
        return None
    paths = c_path if isinstance(c_path, (list, tuple)) else [c_path]
    return np.concatenate([np.load(p).reshape(-1, conf.D_inner)
                           for p in paths], 0).astype(np.float32)


@register_model("ibmil")
def _ibmil(conf):
    return IBMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                 d_inner=conf.D_inner, confounders=_confounders(conf),
                 confounder_merge=str(getattr(conf, "confounder_merge", "cat")),
                 confounder_learn=bool(getattr(conf, "c_learn", False)),
                 generator=_gen(conf))


@register_model("bmil_vis", family="bmil")
def _bmil_vis(conf):
    return BMILVis(n_class=conf.n_class, d_feat=conf.D_feat, with_kl=False,
                   generator=_gen(conf))


@register_model("bmil_enc", family="bmil")
def _bmil_enc(conf):
    return BMILVis(n_class=conf.n_class, d_feat=conf.D_feat, with_kl=True,
                   generator=_gen(conf))


@register_model("bmil_spvis", family="bmil")
def _bmil_spvis(conf):
    return BMILSpvis(n_class=conf.n_class, d_feat=conf.D_feat,
                     grid=int(getattr(conf, "bmil_grid", 64)),
                     generator=_gen(conf))


def _compute_dtype(conf) -> torch.dtype:
    return (torch.bfloat16 if str(getattr(conf, "compute_dtype", "float32"))
            == "bfloat16" else torch.float32)


@register_model("transmil")
def _transmil(conf):
    return TransMIL(n_class=conf.n_class, d_feat=conf.D_feat,
                    d_inner=conf.D_inner, dtype=_compute_dtype(conf),
                    pad_mode=str(getattr(conf, "transmil_pad_mode", "zero")),
                    generator=_gen(conf))


def _mhim_shared_kwargs(conf):
    """The keys the MHIM script gives both stages
    (`Step3_WSI_classification_MHIM.py:50-68,313`), with the script's
    defaults (act and da_act relu, not the class's). ``pos`` picks
    SAttention's positional embedding (ppeg, the JAX registry's only one,
    peg, sincos or none)."""
    return dict(
        n_class=conf.n_class, d_feat=conf.D_feat,
        mlp_dim=int(getattr(conf, "mlp_dim", 512)),
        baseline=str(getattr(conf, "baseline", "selfattn")),
        act=str(getattr(conf, "act", "relu")),
        da_act=str(getattr(conf, "da_act", "relu")),
        droprate=float(getattr(conf, "dropout", 0.25)),
        attn_layer=int(getattr(conf, "attn_layer", 0)),
        pos=str(getattr(conf, "pos", "ppeg")),
        pad_mode=str(getattr(conf, "mhim_pad_mode", "zero")),
        generator=_gen(conf))


@register_model("mhim", family="mhim")
def _mhim(conf):
    return MHIM(dtype=_compute_dtype(conf),
                mask_ratio=float(getattr(conf, "mask_ratio", 0.0)),
                mask_ratio_l=float(getattr(conf, "mask_ratio_l", 0.0)),
                mask_ratio_h=float(getattr(conf, "mask_ratio_h", 0.0)),
                mask_ratio_hr=float(getattr(conf, "mask_ratio_hr", 1.0)),
                **_mhim_shared_kwargs(conf))


@register_model("pure", family="pure")
def _pure(conf):
    """The MHIM script's 'pure' baseline: the same network without masks or
    teacher (`Step3_MHIM:135-137`), which pre-trains the teacher. As in the
    JAX registry, it runs in float32 whatever ``compute_dtype`` says."""
    return MHIM(**_mhim_shared_kwargs(conf))


@register_model("dtfd", family="dtfd")
def _dtfd(conf):
    num_group = int(getattr(conf, "numGroup", 4))
    return DTFD(n_class=conf.n_class, d_feat=conf.D_feat,
                d_inner=conf.D_inner, num_group=num_group,
                instance_per_group=max(
                    1, int(getattr(conf, "total_instance", 4)) // num_group),
                distill=str(getattr(conf, "distill", "MaxMinS")),
                droprate=float(getattr(conf, "droprate", 0.0)),
                generator=_gen(conf))


def model_family(arch: str) -> str:
    """The family ``arch`` trains with, without building it."""
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch][1]


def build_mil_model(conf):
    """Returns (model, family) for ``conf.arch``."""
    family = model_family(conf.arch)
    return _REGISTRY[conf.arch][0](conf), family


__all__ = ["ABMIL", "ACMIL_GA", "ACMIL_MHA", "BMILSpvis", "BMILVis",
           "CLAM_MB", "CLAM_SB", "DAttentionMIL", "DSMIL", "DTFD", "IBMIL", "ILRA",
           "IPSNet", "LBMIL", "MHA", "MHIM", "MaxMIL", "MeanMIL", "TransMIL",
           "build_mil_model", "model_family", "register_model"]
