"""FPN + FPNC neck (counterpart of ``omnihd_scenes_tpu/models/fpnc.py``),
and :func:`resize_bilinear`, the port's ``jax.image.resize(method=
'bilinear')``.

The neck only ever upsamples (backbone strides 8/16/32 to the stride-4
LSS feature map), where ``F.interpolate(bilinear, align_corners=False)``
computes what ``jax.image.resize`` does.  When a dimension shrinks, jax
antialiases (a triangle filter widened by the inverse scale), which
:func:`resize_bilinear` restates with its weight matrices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import FLAX_BN_EPS, BatchNorm
from omnihd_scenes_tpu_torch.models.quant import QConv2d


def _resize_weights(n_in: int, n_out: int, dtype, device):
    """(n_in, n_out) weights of ``jax.image.resize``'s antialiased
    triangle filter (``jax._src.image.scale.compute_weight_mat``), in f32
    (f64 for f64 inputs); divisions by constants as multiplies by their
    reciprocal, as jitted JAX computes them."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=dtype, device=device) + 0.5)
              * inv_scale - 0.5)
    dist = (sample[None, :] - torch.arange(n_in, dtype=dtype,
                                           device=device)[:, None]).abs()
    w = (1 - dist * (1.0 / kernel_scale)).clamp(min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920928955078125e-07,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x, hw):
    """(..., H, W) -> (..., *hw) as ``jax.image.resize(method='bilinear')``:
    ``F.interpolate`` when both dimensions grow or stay, jax's antialiased
    weight matrices when one shrinks."""
    hw = tuple(hw)
    if tuple(x.shape[-2:]) == hw:
        return x
    if hw[0] >= x.shape[-2] and hw[1] >= x.shape[-1]:
        return F.interpolate(x, size=hw, mode='bilinear',
                             align_corners=False)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    wy, wx = (_resize_weights(n_in, n_out, dt, x.device).to(x.dtype)
              for n_in, n_out in zip(x.shape[-2:], hw))
    return torch.einsum('...hw,hy,wx->...yx', x, wy, wx)


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
