"""Shared building blocks (counterpart of ``omnihd_scenes_tpu/models/layers.py``).

Every BatchNorm of the port is :class:`BatchNorm`, with flax's train-mode
semantics, and keeps the epsilon of its flax counterpart: ``BN_EPS`` for
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
# flax's momentum (the weight of the old running value) everywhere.
FLAX_BN_MOMENTUM = 0.99


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of an (N, C, ...) input, as flax's
    ``nn.BatchNorm`` computes it.

    Eval mode, or ``frozen`` (ResNet's frozen backbone BN: running
    statistics in training too, never updated; scale and bias still
    train), normalises with the running statistics.  Train mode
    normalises with the batch statistics and updates the running ones as
    flax does: ``r = 0.99 r + 0.01 s`` with the *biased* batch variance
    (torch's own BatchNorm takes the unbiased one, with momentum 0.1).
    The batch statistics come from the normalising kernel itself
    (``native_batch_norm``'s mean and 1/sqrt(var + eps)), so the update
    costs no extra pass; flax computes the variance as E[x^2] - E[x]^2,
    which differs from torch's in the last bits.  The running statistics
    keep their own dtype (f32 under the bf16 policy) and the update runs
    in it.
    """

    def __init__(self, num_features: int, eps: float, frozen: bool = False):
        super().__init__(num_features, eps=eps, momentum=1 - FLAX_BN_MOMENTUM)
        self.frozen = frozen

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'BatchNorm needs (N, C, ...), got {x.dim()}-d')

    def forward(self, x):
        if self.frozen or not self.training:
            dt = self.running_mean.dtype
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight.to(dt), self.bias.to(dt), False,
                                0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            m = 1 - FLAX_BN_MOMENTUM
            var = (invstd.double() ** -2 - self.eps).clamp_(min=0.0)
            self.running_mean.mul_(FLAX_BN_MOMENTUM).add_(
                mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(FLAX_BN_MOMENTUM).add_(
                var.to(self.running_var.dtype), alpha=m)
        return y


class ConvBNReLU(nn.Module):
    """Conv2d -> BN -> ReLU with torch-style symmetric ``k // 2`` padding,
    which is what the JAX block uses at every stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.conv = QConv2d(in_channels, out_channels, kernel_size,
                            stride=stride, padding=kernel_size // 2,
                            bias=False)
        self.bn = BatchNorm(out_channels, BN_EPS)
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
        self.bn = BatchNorm(out_channels, BN_EPS)

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
