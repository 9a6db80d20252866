"""SECOND backbone + SECONDFPN neck (counterpart of
``omnihd_scenes_tpu/models/second.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import ConvBNReLU, DeconvBNReLU


class SECOND(nn.Module):
    """Stages of one strided ConvBNReLU followed by ``layer_nums[s]``
    stride-1 ones; returns every stage's output."""

    def __init__(self, in_channels: int = 64,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 out_channels: Sequence[int] = (64, 128, 256)):
        super().__init__()
        blocks = []
        for num, stride, ch in zip(layer_nums, layer_strides, out_channels):
            blocks.append(nn.Sequential(
                ConvBNReLU(in_channels, ch, 3, stride=stride),
                *[ConvBNReLU(ch, ch, 3) for _ in range(num)]))
            in_channels = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)


class SECONDFPN(nn.Module):
    """Per-scale deconv to a common stride, channel concat."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 out_channels: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.deblocks = nn.ModuleList([
            DeconvBNReLU(cin, ch, stride) for cin, stride, ch in
            zip(in_channels, upsample_strides, out_channels)])

    def forward(self, feats):
        ups = [deblock(f) for deblock, f in zip(self.deblocks, feats)]
        # Rounding in strided convs can leave the deepest level one texel
        # larger after upsampling.
        min_h = min(u.shape[-2] for u in ups)
        min_w = min(u.shape[-1] for u in ups)
        return torch.cat([u[..., :min_h, :min_w] for u in ups], dim=1)
