"""Shared building blocks (counterpart of ``omnihd_scenes_tpu/models/layers.py``).

Every BatchNorm of the port is :class:`BatchNorm`, with flax's train-mode
semantics, and keeps the epsilon of its flax counterpart: ``BN_EPS`` for
the reference-config blocks (ConvBNReLU, DeconvBNReLU, the pillar PFN),
flax's default ``FLAX_BN_EPS`` for ResNet, ASPP and FPNC.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from omnihd_scenes_tpu_torch.models.quant import QConv2d
from omnihd_scenes_tpu_torch.parallel import mesh as dp

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
    in it.  While :func:`remat` recomputes a forward, ``recomputing`` is
    set and the update is skipped, as flax's ``nn.remat`` records one.

    With a data-parallel group of more than one rank
    (``parallel/mesh.py:sync_group``), train mode normalises with the
    statistics of the global batch, as flax does over JAX's sharded batch
    and the reference's naiveSyncBN over its ranks: the mean from the
    all-reduced sums and counts, then the biased variance from the
    all-reduced sums of (x - mean)^2 (two passes: E[x^2] - E[x]^2 loses
    its digits where a channel's mean dwarfs its spread), in at least
    f32.  The gradient flows through both all-reduces; the running
    statistics update from the global values, so they stay equal on
    every rank.  A recomputation under :func:`remat` issues the same
    collectives again and skips the update.
    """

    def __init__(self, num_features: int, eps: float, frozen: bool = False):
        super().__init__(num_features, eps=eps, momentum=1 - FLAX_BN_MOMENTUM)
        self.frozen = frozen
        self.recomputing = False

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'BatchNorm needs (N, C, ...), got {x.dim()}-d')

    def forward(self, x):
        if self.frozen or not self.training:
            dt = self.running_mean.dtype
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight.to(dt), self.bias.to(dt), False,
                                0.0, self.eps)
        group = dp.sync_group()
        if group is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        else:
            y, mean, var = _global_batch_norm(x, self.weight, self.bias,
                                              self.eps, group)
        if self.recomputing:
            return y
        with torch.no_grad():
            m = 1 - FLAX_BN_MOMENTUM
            if group is None:
                var = (invstd.double() ** -2 - self.eps).clamp_(min=0.0)
            self.running_mean.mul_(FLAX_BN_MOMENTUM).add_(
                mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(FLAX_BN_MOMENTUM).add_(
                var.to(self.running_var.dtype), alpha=m)
        return y


def _global_batch_norm(x, weight, bias, eps: float, group):
    """(y, mean, biased variance) of a train-mode BatchNorm over the
    concatenation of every rank's ``x`` along dim 0; y in x's dtype, the
    statistics in at least f32."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    # The count travels in f64 beside the sums (exact at any size).
    local = torch.cat([xf.sum(dims).double(),
                       xf.new_full((1,), x.numel() // x.shape[1],
                                   dtype=torch.float64)])
    total = dp.all_reduce_sum(local, group)
    count = total[-1]
    mean = (total[:-1] / count).to(xf.dtype)
    centred = xf - mean.reshape(shape)
    var = dp.all_reduce_sum(centred.square().sum(dims), group) / count.to(
        xf.dtype)
    y = centred * torch.rsqrt(var + eps).reshape(shape)
    y = y * weight.to(xf.dtype).reshape(shape) + bias.to(xf.dtype).reshape(
        shape)
    return y.to(x.dtype), mean, var


@contextlib.contextmanager
def _recomputing(module: nn.Module):
    # BatchNorm's running statistics and QConv2d's QAT act_amax.
    mods = [m for m in module.modules() if isinstance(m, (BatchNorm,
                                                          QConv2d))]
    for m in mods:
        m.recomputing = True
    try:
        yield
    finally:
        for m in mods:
            m.recomputing = False


def remat(module: nn.Module, *args):
    """``module(*args)`` rematerialised in the backward, the counterpart
    of flax's ``nn.remat`` (``torch.utils.checkpoint``, non-reentrant, so
    a trunk whose input needs no gradient still gives its parameters
    theirs).  The forward runs on the parameters ``module`` holds now,
    which under ``functional_call`` (the bf16 policy's copies) are not the
    ones it holds when the backward recomputes, so both runs take them
    explicitly.  The recomputation leaves BatchNorm's running statistics
    and the QAT ``act_amax`` alone: one update per step, as without
    remat."""
    params = dict(module.named_parameters())
    return checkpoint(
        lambda *a: functional_call(module, params, a), *args,
        use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing(module)))


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


def same_padding(size: int, kernel: int, stride: int):
    """flax ``'SAME'`` padding (low, high) of one axis: the output has
    ceil(size / stride) entries and the odd pixel goes to the high side."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class DeconvBNReLU(nn.Module):
    """ConvTranspose2d(kernel = stride) -> BN -> ReLU (SECONDFPN upsample).

    A fractional stride 1/s downsamples instead, as in JAX: an s x s
    ``QConv2d`` (``conv``; the bridge's ``Conv_0``) at stride s with flax
    ``'SAME'`` padding.
    """

    def __init__(self, in_channels: int, out_channels: int, stride):
        super().__init__()
        if stride >= 1:
            self.deconv = nn.ConvTranspose2d(in_channels, out_channels,
                                             stride, stride=stride,
                                             bias=False)
        else:
            s = int(round(1 / stride))
            self.conv = QConv2d(in_channels, out_channels, s, stride=s,
                                bias=False)
        self.bn = BatchNorm(out_channels, BN_EPS)

    def forward(self, x):
        if hasattr(self, 'deconv'):
            return F.relu(self.bn(self.deconv(x)))
        s = self.conv.stride[0]
        (top, bottom), (left, right) = (same_padding(n, s, s)
                                        for n in x.shape[-2:])
        x = F.pad(x, (left, right, top, bottom))
        return F.relu(self.bn(self.conv(x)))


class SEBlock(nn.Module):
    """Squeeze-excitation gate of the BEVFusion fuser."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        w = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return x * torch.sigmoid(w)
