"""Shared building blocks (counterpart of ``omnihd_scenes_tpu/models/layers.py``).

Each BatchNorm keeps the epsilon of its flax counterpart: ``BN_EPS`` for
the reference-config blocks (ConvBNReLU, DeconvBNReLU, the pillar PFN),
flax's default ``FLAX_BN_EPS`` for ResNet, ASPP and FPNC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.quant import QConv2d

BN_EPS = 1e-3
FLAX_BN_EPS = 1e-5


class ConvBNReLU(nn.Module):
    """Conv2d -> BN -> ReLU with torch-style symmetric ``k // 2`` padding,
    which is what the JAX block uses at every stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.conv = QConv2d(in_channels, out_channels, kernel_size,
                            stride=stride, padding=kernel_size // 2,
                            bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class DeconvBNReLU(nn.Module):
    """ConvTranspose2d(kernel = stride) -> BN -> ReLU (SECONDFPN upsample).

    The JAX block also accepts a fractional stride (a strided conv with
    flax 'SAME' padding); no configuration uses it and it is not ported.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        if stride < 1:
            raise NotImplementedError(
                f'fractional SECONDFPN stride {stride} is not ported')
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, stride,
                                         stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.deconv(x)))


class SEBlock(nn.Module):
    """Squeeze-excitation gate of the BEVFusion fuser."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        w = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return x * torch.sigmoid(w)
