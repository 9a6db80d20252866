"""Modulated deformable convolution v2 (counterpart of
``omnihd_scenes_tpu/models/dcn.py``; reference mmcv
``ModulatedDeformConv2dPack``, ``deform_groups=1``, the DCNv2 stages of
BEVFormer-T's R101-DCN backbone).

The 3x3 kernel (the only size ResNet's DCN stages use) has no bias.  A
sibling conv, ``conv_offset``, zero-initialised, predicts per output pixel
18 offsets in mmcv's interleaved layout (dy0, dx0, dy1, dx1, ...) and 9
modulation masks (sigmoid of its last 9 channels).  Tap (ky, kx) of output
pixel (i, j) reads the input at ``(i * stride + ky - 1 + dy, j * stride +
kx - 1 + dx)`` bilinearly through
``ops/ms_deform_attn.py:bilinear_sample`` (the JAX package's form: taps
off the map read 0), times its mask; one contraction with the kernel,
accumulated in at least f32, gives the output in the input's dtype.  Plain
PyTorch: autograd gives the gradient through the sampling.

The kernel is stored as a conv's (F, C, 3, 3), so the weight bridge maps
it as it maps a conv (flax keeps (3, 3, C, F)).
"""

from __future__ import annotations

import torch
from torch import nn

from omnihd_scenes_tpu_torch.ops.ms_deform_attn import (at_least_f32,
                                                    bilinear_sample)

K = 3                                   # kernel size; padding K // 2


class DeformConv(nn.Module):
    """DCNv2 3x3, stride 1 or 2, padding 1, no bias."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv_offset = nn.Conv2d(in_channels, 3 * K * K, K, stride=stride,
                                     padding=K // 2, bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, K,
                                               K))
        nn.init.kaiming_normal_(self.weight)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, F, H', W') in x's dtype."""
        kk = K * K
        off_mask = self.conv_offset(x)                  # (B, 3kk, H', W')
        b, _, oh, ow = off_mask.shape
        off_y = off_mask[:, 0:2 * kk:2]
        off_x = off_mask[:, 1:2 * kk:2]
        mask = torch.sigmoid(off_mask[:, 2 * kk:])
        dev = x.device
        gy = torch.arange(oh, dtype=torch.float32, device=dev) * self.stride
        gx = torch.arange(ow, dtype=torch.float32, device=dev) * self.stride
        taps = torch.arange(K, dtype=torch.float32, device=dev) - K // 2
        ky = taps.repeat_interleave(K)                  # row-major taps
        kx = taps.repeat(K)
        sample_y = gy[None, None, :, None] + ky[None, :, None, None] + off_y
        sample_x = gx[None, None, None, :] + kx[None, :, None, None] + off_x
        loc = torch.stack([sample_x, sample_y], -1)     # (B, kk, H', W', 2)
        value = x.permute(0, 2, 3, 1)                   # (B, H, W, C)
        sampled = bilinear_sample(value, loc)           # (B, kk, H', W', C)
        sampled = sampled * mask[..., None]
        kernel = self.weight.permute(2, 3, 1, 0).reshape(
            kk, x.shape[1], self.weight.shape[0])
        return torch.einsum('bkhwc,kcf->bfhw', at_least_f32(sampled),
                            at_least_f32(kernel)).to(x.dtype)
