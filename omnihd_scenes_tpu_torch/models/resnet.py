"""ResNet image backbone (counterpart of ``omnihd_scenes_tpu/models/resnet.py``).

torchvision naming (``conv1``, ``layer{s}.{j}.conv1`` ...), so the JAX
package's ``train/torch_import.resnet_name_map`` maps it onto the flax
tree.  The port serves inference only: every BatchNorm runs on its
running statistics, which is what the reference's frozen backbone BN
(``norm_eval=True``) does in both training and eval.  The space-to-depth
stem and DCN stages are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import FLAX_BN_EPS
from omnihd_scenes_tpu_torch.models.quant import QConv2d


def _downsample(in_channels, out_channels, stride):
    return nn.Sequential(
        QConv2d(in_channels, out_channels, 1, stride=stride, bias=False),
        nn.BatchNorm2d(out_channels, eps=FLAX_BN_EPS))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = QConv2d(in_channels, planes, 3, stride=stride,
                             padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=FLAX_BN_EPS)
        self.conv2 = QConv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=FLAX_BN_EPS)
        self.downsample = (_downsample(in_channels, planes, stride)
                           if stride != 1 or in_channels != planes else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        out_channels = planes * self.expansion
        self.conv1 = QConv2d(in_channels, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=FLAX_BN_EPS)
        self.conv2 = QConv2d(planes, planes, 3, stride=stride, padding=1,
                             bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=FLAX_BN_EPS)
        self.conv3 = QConv2d(planes, out_channels, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_channels, eps=FLAX_BN_EPS)
        self.downsample = (_downsample(in_channels, out_channels, stride)
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
    """Multi-stage ResNet; returns the features of ``out_indices``."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        block, stage_blocks = ARCHS[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = QConv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=FLAX_BN_EPS)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_channels = 64
        self.stage_channels = []
        for s, n_blocks in enumerate(stage_blocks):
            planes = 64 * 2 ** s
            layers = []
            for j in range(n_blocks):
                layers.append(block(in_channels, planes,
                                    stride=2 if s > 0 and j == 0 else 1))
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
