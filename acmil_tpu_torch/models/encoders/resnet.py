"""ResNet-18/50 patch encoders, the port of
``acmil_tpu/models/encoders/resnet.py``.

The reference's torchvision-style ResNets (`models.py:13-111`) and the
Lunit/DINO ResNet-50 trunks, with torchvision's parameter names (``conv1``,
``bn1``, ``layerI.J.convK``, ``layerI.J.downsample.0/1``), so a
torchvision-layout checkpoint loads once its ``fc`` and
``num_batches_tracked`` keys are dropped
(``encoders/convert.py::resnet_state_dict``).

Extraction is eval-only: batch norm runs on its frozen statistics (eps
1e-5), folded into a per-channel scale and shift computed in float32. The
input is NHWC, as ``build.preprocess`` gives it; the trunk reads it as
channels-last NCHW, the layout cuDNN's convolutions take best. Parameters
are float32; the forward computes in ``dtype`` (bfloat16 through
``build.build_encoder``, as in the JAX package), and
:meth:`ResNet.cast_convs_` casts the convolution weights to it once. The
JAX package runs these convolutions in XLA, outside any Pallas kernel, so
the port runs them through cuDNN.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """A bias-free convolution in its input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride, padding, bias=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


class FrozenBatchNorm2d(nn.Module):
    """Batch norm on frozen statistics: ``(x - mean) / sqrt(var + eps) *
    weight + bias`` as one scale and shift per channel."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1)
        self.bn2 = FrozenBatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class Bottleneck(nn.Module):
    """torchvision's v1.5 bottleneck: the stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


def _downsample(cin: int, cout: int, stride: int):
    """The projection shortcut where the block changes shape, else None."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class ResNet(nn.Module):
    """images NHWC ``[B, H, W, 3]`` → globally average-pooled features
    ``[B, embed_dim]`` in ``dtype``."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: Type[nn.Module] = BasicBlock,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.embed_dim = 512 * block.expansion
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for i, (n_blocks, width) in enumerate(zip(stage_sizes,
                                                  (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block(cin, width, 2 if i > 0 and j == 0 else 1))
                cin = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def cast_convs_(self, dtype: torch.dtype) -> "ResNet":
        """Every convolution weight to ``dtype`` and channels-last, once;
        the batch-norm parameters stay float32."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.weight.data = m.weight.data.to(
                    dtype, memory_format=torch.channels_last)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)   # channels-last NCHW
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))


def resnet18(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, dtype)


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, dtype)
