"""ResNet image backbone (counterpart of ``omnihd_scenes_tpu/models/resnet.py``).

torchvision naming (``conv1``, ``layer{s}.{j}.conv1`` ...), so the JAX
package's ``train/torch_import.resnet_name_map`` maps it onto the flax
tree.  With ``frozen_bn`` (the reference's ``norm_eval=True``, the JAX
``ResNet.frozen_bn``) every BatchNorm runs on its running statistics in
training as in eval and never updates them; their scale and bias still
train.  ``stage_with_dcn`` puts DCNv2 (``models/dcn.py:DeformConv``)
on the 3x3 convs of a stage's blocks (the reference's R101-DCN), with the
stride on the deformable conv; the module keeps its conv's name.
``stem_s2d`` takes space-to-depth packed images and runs the stem as the
exact 4x4 conv of :class:`S2DStem`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.dcn import DeformConv
from omnihd_scenes_tpu_torch.models.layers import FLAX_BN_EPS, BatchNorm
from omnihd_scenes_tpu_torch.models.quant import QConv2d


def space_to_depth(x):
    """(..., H, W, C) -> (..., H/2, W/2, 4C), the packed channel
    ``(qy * 2 + qx) * C + c`` holding pixel (2i + qy, 2j + qx, c) (JAX
    ``resnet.py:space_to_depth``)."""
    *lead, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'space_to_depth needs even H and W, got {h}x{w}')
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, c).movedim(-4, -3)
    return x.reshape(*lead, h // 2, w // 2, 4 * c)


def space_to_depth_np(x: np.ndarray) -> np.ndarray:
    """:func:`space_to_depth` in NumPy, for the host side of a request."""
    *lead, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'space_to_depth needs even H and W, got {h}x{w}')
    x = np.moveaxis(x.reshape(*lead, h // 2, 2, w // 2, 2, c), -4, -3)
    return np.ascontiguousarray(x).reshape(*lead, h // 2, w // 2, 4 * c)


class S2DStem(QConv2d):
    """The ResNet stem on space-to-depth packed input (JAX
    ``resnet.py:_S2DStem``): the 7x7 stride-2 pad-3 conv as a 4x4
    stride-1 conv, padded (2, 1) on each axis, over the (qy, qx, c)
    packed channels.  The stored weight keeps the standard stem's name
    and (F, C, 7, 7) shape; each call pads it at the front to 8x8 and
    rearranges it, so checkpoints and the weight bridge do not change.

    ``calib`` and ``qat`` record ``act_amax`` as the standard stem does
    (packing moves pixels, so max|x| is the same; ``qat`` its EMA, JAX
    ``resnet.py:89-100``); in every mode the conv runs in float, and ``freeze`` stores no int8 weights: JAX leaves this stem
    out of the int8 tier."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64):
        super().__init__(in_channels, out_channels, 7, stride=2, padding=3,
                         bias=False)

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """(F, 4C, 4, 4) kernel of the packed conv."""
        f, c = self.out_channels, self.in_channels
        w8 = F.pad(self.weight.to(dtype), (1, 0, 1, 0))      # (F, C, 8, 8)
        w8 = w8.view(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        return w8.reshape(f, 4 * c, 4, 4)

    def forward(self, x):
        if self.mode in ('calib', 'qat'):
            self.record_amax(x)
        return F.conv2d(F.pad(x, (2, 1, 2, 1)), self.packed_weight(x.dtype))


def _conv3x3(in_channels, out_channels, stride, dcn):
    if dcn:
        return DeformConv(in_channels, out_channels, stride=stride)
    return QConv2d(in_channels, out_channels, 3, stride=stride, padding=1,
                   bias=False)


def _downsample(in_channels, out_channels, stride, frozen):
    return nn.Sequential(
        QConv2d(in_channels, out_channels, 1, stride=stride, bias=False),
        BatchNorm(out_channels, FLAX_BN_EPS, frozen))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 frozen: bool = False, dcn: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(in_channels, planes, stride, dcn)
        self.bn1 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv2 = _conv3x3(planes, planes, 1, dcn)
        self.bn2 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.downsample = (_downsample(in_channels, planes, stride, frozen)
                           if stride != 1 or in_channels != planes else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 frozen: bool = False, dcn: bool = False):
        super().__init__()
        out_channels = planes * self.expansion
        self.conv1 = QConv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv2 = _conv3x3(planes, planes, stride, dcn)
        self.bn2 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv3 = QConv2d(planes, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels, FLAX_BN_EPS, frozen)
        self.downsample = (_downsample(in_channels, out_channels, stride,
                                       frozen)
                           if stride != 1 or in_channels != out_channels
                           else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


ARCHS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """Multi-stage ResNet; returns the features of ``out_indices``.  With
    ``stem_s2d`` the input is :func:`space_to_depth` packed (N, 12, H/2,
    W/2) and the outputs are those of the standard stem on the unpacked
    image."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (1, 2, 3),
                 frozen_bn: bool = True,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 stem_s2d: bool = False):
        super().__init__()
        block, stage_blocks = ARCHS[depth]
        self.out_indices = tuple(out_indices)
        self.stage_with_dcn = tuple(stage_with_dcn)
        self.conv1 = (S2DStem(3, 64) if stem_s2d else
                      QConv2d(3, 64, 7, stride=2, padding=3, bias=False))
        self.bn1 = BatchNorm(64, FLAX_BN_EPS, frozen_bn)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_channels = 64
        self.stage_channels = []
        for s, n_blocks in enumerate(stage_blocks):
            planes = 64 * 2 ** s
            layers = []
            for j in range(n_blocks):
                layers.append(block(in_channels, planes,
                                    stride=2 if s > 0 and j == 0 else 1,
                                    frozen=frozen_bn,
                                    dcn=self.stage_with_dcn[s]))
                in_channels = planes * block.expansion
            self.add_module(f'layer{s + 1}', nn.Sequential(*layers))
            self.stage_channels.append(in_channels)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.stage_channels[i] for i in self.out_indices)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for s in range(len(self.stage_channels)):
            x = getattr(self, f'layer{s + 1}')(x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
