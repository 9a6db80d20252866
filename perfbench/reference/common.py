"""Plain float32 building blocks shared by the references: eval-mode
BatchNorm, the conv blocks, ResNet, FPN, FPNC and the bilinear resize.

A frozen copy of the port's modules at the time the benchmark was
defined (``models/layers.py``, ``resnet.py``, ``fpnc.py``), every conv a
plain ``nn.Conv2d``.  Module and parameter
names are the port's, so one state dict loads into both.  Nothing here
imports the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
FLAX_BN_EPS = 1e-5


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1.  In eval mode, or ``frozen`` (the backbone's),
    it normalises with the running statistics; in training mode with the
    batch's (biased variance, as flax).  The running statistics are never
    updated here: a training step's loss and gradients read only the
    batch's."""

    def __init__(self, num_features: int, eps: float, frozen: bool = False):
        super().__init__(num_features, eps=eps)
        self.frozen = frozen

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'BatchNorm needs (N, C, ...), got {x.dim()}-d')

    def forward(self, x):
        if self.frozen or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=False)
        self.bn = BatchNorm(out_channels, BN_EPS)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class DeconvBNReLU(nn.Module):
    """ConvTranspose2d(kernel = stride) -> BN -> ReLU (integer strides)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, stride,
                                         stride=stride, bias=False)
        self.bn = BatchNorm(out_channels, BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.deconv(x)))


class SEBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(x.mean(dim=(2, 3), keepdim=True)))


def _downsample(in_channels, out_channels, stride, frozen):
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
        BatchNorm(out_channels, FLAX_BN_EPS, frozen))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 frozen: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.downsample = (_downsample(in_channels, planes, stride, frozen)
                           if stride != 1 or in_channels != planes else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 frozen: bool = False):
        super().__init__()
        out_channels = planes * self.expansion
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm(planes, FLAX_BN_EPS, frozen)
        self.conv3 = nn.Conv2d(planes, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels, FLAX_BN_EPS, frozen)
        self.downsample = (_downsample(in_channels, out_channels, stride,
                                       frozen)
                           if stride != 1 or in_channels != out_channels
                           else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


ARCHS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """torchvision-named ResNet returning the stages of ``out_indices``;
    ``frozen``: every BatchNorm on its running statistics in training
    too (the reference's ``norm_eval``)."""

    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (1, 2, 3),
                 frozen: bool = True):
        super().__init__()
        block, stage_blocks = ARCHS[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, FLAX_BN_EPS, frozen)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_channels = 64
        self.stage_channels = []
        for s, n_blocks in enumerate(stage_blocks):
            planes = 64 * 2 ** s
            layers = []
            for j in range(n_blocks):
                layers.append(block(in_channels, planes,
                                    stride=2 if s > 0 and j == 0 else 1,
                                    frozen=frozen))
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


def _resize_weights(n_in: int, n_out: int, dtype, device):
    """``jax.image.resize``'s antialiased triangle filter (n_in, n_out)."""
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
    """(..., H, W) -> (..., *hw) as ``jax.image.resize(method='bilinear')``."""
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
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)
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
        self.reduce_conv = nn.Conv2d(out_channels * len(in_channels), outC,
                                     3, padding=1, bias=False)
        self.bn = BatchNorm(outC, FLAX_BN_EPS)

    def forward(self, feats):
        outs = self.fpn(feats)
        x = torch.cat([resize_bilinear(f, self.target_hw) for f in outs],
                      dim=1)
        return F.relu(self.bn(self.reduce_conv(x)))
