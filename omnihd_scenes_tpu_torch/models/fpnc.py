"""FPN + FPNC neck (counterpart of ``omnihd_scenes_tpu/models/fpnc.py``).

The neck only ever upsamples (backbone strides 8/16/32 to the stride-4
LSS feature map), where ``F.interpolate(bilinear, align_corners=False)``
computes what ``jax.image.resize(method='bilinear')`` does.  Downsampling
would differ (jax antialiases), so :func:`resize_bilinear` refuses it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import FLAX_BN_EPS, BatchNorm
from omnihd_scenes_tpu_torch.models.quant import QConv2d


def resize_bilinear(x, hw):
    hw = tuple(hw)
    if tuple(x.shape[-2:]) == hw:
        return x
    if hw[0] < x.shape[-2] or hw[1] < x.shape[-1]:
        raise NotImplementedError(
            f'bilinear downsampling {tuple(x.shape[-2:])} -> {hw} is not '
            'ported (jax.image.resize antialiases)')
    return F.interpolate(x, size=hw, mode='bilinear', align_corners=False)


class FPN(nn.Module):
    """Top-down feature pyramid over backbone stages.  The flax 3x3
    'SAME' convs are stride 1, where they equal padding=1."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [QConv2d(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [QConv2d(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, feats):
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[-2:])
        return [conv(l) for conv, l in zip(self.fpn_convs, laterals)]


class FPNC(nn.Module):
    """FPN -> resize to ``target_hw`` -> concat -> 3x3 reduce conv."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 outC: int = 256, target_hw: Tuple[int, int] = (136, 240)):
        super().__init__()
        self.target_hw = tuple(target_hw)
        self.fpn = FPN(in_channels, out_channels)
        self.reduce_conv = QConv2d(out_channels * len(in_channels), outC,
                                   3, padding=1, bias=False)
        self.bn = BatchNorm(outC, FLAX_BN_EPS)

    def forward(self, feats):
        outs = self.fpn(feats)
        x = torch.cat([resize_bilinear(f, self.target_hw) for f in outs],
                      dim=1)
        return F.relu(self.bn(self.reduce_conv(x)))
