"""The controls: a reference run one precision step below the
configuration's.

``lower(model, 'fp8')`` rounds every conv's and linear's weight and
input to float8 e4m3 (per-tensor scale to its largest magnitude, the
recipe of fp8 inference), accumulating in f32: the step below bfloat16.
``lower(model, 'tf32')`` rounds them to TF32 (10 mantissa bits, what
cuBLAS and cuDNN do to f32 operands with TF32 allowed), accumulating in
f32: the step below float32 with TF32 off.  Both round on any device, so
the CPU tests run the same control as the card.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn.utils import parametrize

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, returned
    in its own dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to the nearest TF32 (10 mantissa bits, ties
    away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


ROUND = {'fp8': round_fp8, 'tf32': round_tf32}


class _Rounded(nn.Module):
    """A parametrization: the weight as rounded, its gradient passed
    straight through."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, w):
        return w + (self.fn(w) - w).detach()


def lower(model: nn.Module, kind: str) -> None:
    """Round the weight and the input of every conv and linear of
    ``model`` to ``kind`` at every call (straight through for the
    gradients, so that a training step runs the control too)."""
    fn = ROUND[kind]

    def round_inputs(module, args):
        return tuple(a + (fn(a) - a).detach()
                     if isinstance(a, torch.Tensor) and a.is_floating_point()
                     else a for a in args)
    for m in list(model.modules()):
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            parametrize.register_parametrization(m, 'weight', _Rounded(fn))
            m.register_forward_pre_hook(round_inputs)


def plain_name(name: str) -> str:
    """A parameter's name without :func:`lower`'s parametrization."""
    return name.replace('parametrizations.', '').replace('.original', '')


@contextlib.contextmanager
def no_tf32():
    """The reference's precision: f32 operands on cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
