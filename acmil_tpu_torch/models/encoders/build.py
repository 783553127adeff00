"""Encoder factory, preprocessing and the Step2 feature closure, the port of
``acmil_tpu/models/encoders/build.py``.

``ENCODER_SPECS`` mirrors the reference's ``build_model`` dispatch on
``(pretrain, backbone)`` (``models.py:191-206``) with the eval-transform
constants (ImageNet mean/std for pretrained encoders, 0.5/0.5 otherwise,
CLIP's own): the ViT trunks and the ResNet-18/50 trunks
(``encoders/resnet.py``).

Weights load from a local torch checkpoint (``conf.pretrain_weights``);
without one the encoder keeps its random initialisation, with a warning.
"""

from __future__ import annotations

import copy
import warnings
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from acmil_tpu_torch.models.encoders.resnet import ResNet, resnet18, resnet50
from acmil_tpu_torch.models.encoders.vit import ViT

IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
HALF_MEAN, HALF_STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
CLIP_MEAN, CLIP_STD = ((0.48145466, 0.4578275, 0.40821073),
                       (0.26862954, 0.26130258, 0.27577711))


@dataclass
class EncoderSpec:
    builder: Callable
    embed_dim: int
    img_size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    converter: str   # 'vit' | 'clip_vit' | 'resnet'
    depth: int = 12


ENCODER_SPECS = {
    # (pretrain, backbone) keys follow models.py:191-206
    ("medical_ssl", "ViT-S/16"): EncoderSpec(
        lambda dt: ViT(16, 384, 12, 6, dtype=dt), 384, 224,
        HALF_MEAN, HALF_STD, "vit"),
    ("natural_supervised", "ViT-B/16"): EncoderSpec(
        lambda dt: ViT(16, 768, 12, 12, dtype=dt), 768, 224,
        IMAGENET_MEAN, IMAGENET_STD, "vit"),
    ("natural_ssl", "ViT-S/16"): EncoderSpec(
        lambda dt: ViT(16, 768, 12, 12, dtype=dt), 768, 224,
        IMAGENET_MEAN, IMAGENET_STD, "vit"),
    ("natural_supervised", "Resnet18"): EncoderSpec(
        resnet18, 512, 224, IMAGENET_MEAN, IMAGENET_STD, "resnet"),
    ("natural_supervised", "resnet18"): EncoderSpec(
        resnet18, 512, 224, IMAGENET_MEAN, IMAGENET_STD, "resnet"),
    ("natural_supervised", "Resnet50"): EncoderSpec(
        resnet50, 2048, 224, IMAGENET_MEAN, IMAGENET_STD, "resnet"),
    ("medical_ssl", "Resnet50"): EncoderSpec(
        resnet50, 2048, 224, HALF_MEAN, HALF_STD, "resnet"),
    # DINO ResNet50 (models.py:208-210: a torchvision-layout RN50 trunk)
    ("natural_ssl", "Resnet50"): EncoderSpec(
        resnet50, 2048, 224, IMAGENET_MEAN, IMAGENET_STD, "resnet"),
    # Lunit pathology DINO ViT-S/8 (models.py:117-121)
    ("medical_ssl", "ViT-S/8"): EncoderSpec(
        lambda dt: ViT(8, 384, 12, 6, dtype=dt), 384, 224,
        HALF_MEAN, HALF_STD, "vit"),
    # UNI: DINOv2 ViT-L/16 with layerscale, 1024-d
    ("UNI", "ViT-L/16"): EncoderSpec(
        lambda dt: ViT(16, 1024, 24, 16, layerscale=True, dtype=dt), 1024,
        224, IMAGENET_MEAN, IMAGENET_STD, "vit", depth=24),
    # GigaPath tile encoder: DINOv2 ViT-G/16, 1536-d, depth 40, SwiGLU-packed
    # MLP, layerscale
    ("GigaPath", "ViT-G/16"): EncoderSpec(
        lambda dt: ViT(16, 1536, 40, 24, mlp_ratio=16.0 / 3.0, act="swiglu",
                       layerscale=True, dtype=dt), 1536, 224,
        IMAGENET_MEAN, IMAGENET_STD, "vit", depth=40),
    ("path-clip-L-336", "ViT-L/336"): EncoderSpec(
        lambda dt: ViT(14, 1024, 24, 16, img_size=336, proj_dim=768,
                       pre_norm=True, act="quick_gelu", dtype=dt), 768, 336,
        CLIP_MEAN, CLIP_STD, "clip_vit", depth=24),
    ("openai-clip-L-336", "ViT-L/336"): EncoderSpec(
        lambda dt: ViT(14, 1024, 24, 16, img_size=336, proj_dim=768,
                       pre_norm=True, act="quick_gelu", dtype=dt), 768, 336,
        CLIP_MEAN, CLIP_STD, "clip_vit", depth=24),
}

# pretrains that imply the encoder no matter what cfg.backbone says
PRETRAIN_ONLY = {
    "tailored_sl": ("medical_ssl", "ViT-S/16"),   # models.py:213-214
    "UNI": ("UNI", "ViT-L/16"),
    "GigaPath": ("GigaPath", "ViT-G/16"),
}


class CustomModel(nn.Module):
    """Encoder + linear head with ``return_feature`` (``models.py:164-179``)."""

    def __init__(self, encoder: nn.Module, n_class: int):
        super().__init__()
        self.encoder = encoder
        self.head = nn.Linear(encoder.embed_dim, n_class)

    def forward(self, images, return_feature: bool = True):
        feat = self.encoder(images)
        logits = self.head(feat)
        return (logits, feat) if return_feature else logits


def encoder_spec(conf) -> EncoderSpec:
    key = (conf.pretrain, conf.backbone)
    spec = ENCODER_SPECS.get(key)
    if spec is None and conf.pretrain in PRETRAIN_ONLY:
        spec = ENCODER_SPECS[PRETRAIN_ONLY[conf.pretrain]]
    if spec is None:
        raise ValueError(f"unknown encoder {key}; have {sorted(ENCODER_SPECS)}")
    return spec


def build_encoder(conf, dtype=torch.bfloat16):
    """Returns (model, spec, encoder state dict or None).

    The state dict is converted from ``conf.pretrain_weights`` when given;
    otherwise None, and the model keeps the random initialisation it was
    built with. In bf16 the ViT module's attention is kernel B5' with a bf16
    softmax, as in the JAX package, and a ResNet computes in bf16; Step2
    itself runs :func:`encoder_feature_fn`, which takes every ViT through
    ``vit_encode``.
    """
    spec = encoder_spec(conf)
    encoder = spec.builder(dtype)
    if dtype == torch.bfloat16 and isinstance(encoder, ViT):
        for blk in encoder.blocks:
            blk.attn.softmax_f32, blk.attn.attn_impl = False, "fused"
    model = CustomModel(encoder, conf.n_class)
    state = None
    wpath = getattr(conf, "pretrain_weights", "")
    if wpath:
        from acmil_tpu_torch.models.encoders import convert as C

        sd = C.load_torch_checkpoint(wpath)
        if spec.converter == "resnet":
            state = C.resnet_state_dict(sd)
        elif spec.converter == "clip_vit":
            state = C.convert_clip_vit(sd, depth=spec.depth)
        else:
            state = C.vit_state_dict(sd, depth=spec.depth)
        model.encoder.load_state_dict(state)
    else:
        warnings.warn(
            f"no pretrain_weights given for {(conf.pretrain, conf.backbone)}: "
            "the encoder keeps its random initialisation (supply a local "
            "torch checkpoint)")
    return model, spec, state


def preprocess(images_u8: torch.Tensor, spec: EncoderSpec,
               dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` → normalised ``[B, H, W, 3]`` in ``dtype``
    (eval_transforms, ``dataset_h5.py:20-37``), on the images' device."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(spec.std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def encoder_feature_fn(model: CustomModel, spec: EncoderSpec,
                       device: torch.device, fused: bool = True,
                       out_dtype: torch.dtype = torch.float16):
    """Step2's feature closure: a uint8 ``[B, H, W, 3]`` numpy batch on the
    host → ``[B, embed_dim]`` features in ``out_dtype`` on ``device``. A ViT
    runs through :func:`~acmil_tpu_torch.models.encoders.fast.vit_encode`
    (kernels B3, B4 and B5' on CUDA), a ResNet through its plain forward
    (cuDNN's convolutions, as the JAX package runs them in XLA). The
    encoder's parameters go to the device once, here, with the matrices of
    the route's kernel (a ResNet: its convolutions) cast to its dtype once.
    ``fused=False`` makes ``vit_encode`` use the kernels' plain versions
    (tests and ``chip_smoke.py`` compare the two)."""
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_encode)

    enc = model.encoder
    pin = device.type == "cuda"

    def to_device(images_u8):
        t = torch.from_numpy(np.ascontiguousarray(images_u8))
        return t.pin_memory().to(device, non_blocking=True) if pin else t

    if isinstance(enc, ResNet):
        trunk = copy.deepcopy(enc).to(device).eval().cast_convs_(enc.dtype)

        @torch.no_grad()
        def resnet_fn(images_u8):
            x = preprocess(to_device(images_u8), spec, dtype=enc.dtype)
            return trunk(x).to(out_dtype)

        return resnet_fn
    params = cast_kernel_weights(
        {k: v.detach().to(device) for k, v in enc.state_dict().items()},
        n_tok=(enc.img_size // enc.patch) ** 2 + 1, heads=enc.heads,
        dtype=enc.dtype, act=enc.act)

    @torch.no_grad()
    def feat_fn(images_u8):
        x = preprocess(to_device(images_u8), spec, dtype=enc.dtype)
        return vit_encode(params, x, patch=enc.patch, depth=enc.depth,
                          heads=enc.heads, dtype=enc.dtype, act=enc.act,
                          pre_norm=enc.pre_norm, proj_dim=enc.proj_dim,
                          fused=fused).to(out_dtype)

    return feat_fn
