"""int8 quantization of conv layers: post-training quantization and
quantization-aware training (counterpart of
``omnihd_scenes_tpu/models/quant.py``).

Symmetric, no zero points: a per-tensor activation scale
``sx = act_amax / 127`` and per-output-channel weight scales ``sw``;
``y = conv_s8(x8, w8) * (sx * sw) + bias`` summed exactly in integers and
returned in the input's dtype.

Flow, per model (the JAX package's mode is process-wide; here it is an
attribute of each :class:`QConv2d`, set by :func:`set_mode`)::

    set_mode(model, 'calib');  model(*batch)  # PTQ: records act_amax
    # or, QAT: set_mode(model, 'qat') and train (make_train_step): the
    # convs run on fake-quantized operands, act_amax an EMA over steps
    set_mode(model, 'freeze'); model(*batch)  # stores w8, w_scale
    state = quant_state(model)                # the JAX 'quant' collection
    load_quant_state(model, state); set_mode(model, 'int8')

:func:`calibrate_model` runs the PTQ steps for any model.  ``qat`` is
JAX's ``Conv._qat``: ``act_amax`` becomes ``0.99 a + 0.01 max|x|`` once
a forward (the first batch sets it), not again while
``models/layers.py:remat`` recomputes (``recomputing``); the conv runs in
float on ``fake_quant(x, max(act_amax, 1e-6) / 127)`` and
``fake_quant(W, max|W[o]| / 127)`` with a straight-through gradient.  As
in JAX, no CLI or train loop has a QAT flag: ``make_train_step`` carries
``act_amax`` in the modules' buffers, as it carries BatchNorm's running
statistics.  The space-to-depth stem (``models/resnet.py:S2DStem``)
records its ``act_amax`` in ``calib`` and ``qat`` and stays float, so its
state has no ``w8`` / ``w_scale``.

The quantization state lives in non-persistent buffers, so
``state_dict()`` stays the float checkpoint in every mode, as JAX keeps
the ``quant`` collection apart from ``params``.  ``act_amax`` and
``w_scale`` stay float32 and ``w8`` int8 when the model is cast (the JAX
bench keeps the collection in f32 beside bf16 params), and ``w8`` is
kept channels_last: that is the fused kernel's layout, packed once.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from omnihd_scenes_tpu_torch.ops.qconv import (INV_127, qconv3x3,
                                               quantize_act, quantize_weights)

MODES = ('off', 'calib', 'freeze', 'int8', 'qat')
QUANT_KEYS = ('act_amax', 'w8', 'w_scale')


def qconv_eligible(conv: nn.Conv2d) -> bool:
    """The fused kernel's gate (``quant.py:_fused_eligible`` without its
    TPU backend and VMEM terms): 3x3, stride 1, dilation 1, ungrouped,
    zero padding 1, C and Co multiples of 128.  The kernel's wrapper
    launches on CUDA tensors and runs its plain version on CPU ones."""
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.dilation == (1, 1) and conv.groups == 1
            and conv.padding in ((1, 1), 'same')
            and conv.padding_mode == 'zeros'
            and conv.in_channels % 128 == 0 and conv.out_channels % 128 == 0)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` with the int8 PTQ path of ``quant.Conv``.

    ``off`` is exactly ``nn.Conv2d``.  ``calib`` runs float and records
    ``act_amax = max(act_amax, max|x|)`` in f32.  ``freeze`` runs float and
    stores ``w8, w_scale = quantize_weights(weight)`` from the weight in
    its current dtype.  ``int8`` quantizes the input and runs the s8
    conv: eligible layers through :func:`qconv3x3`, the others as an f32
    conv of the int8 values (exact while partial sums stay below 2^24;
    TF32 represents the values exactly too).  ``qat`` is JAX's
    ``Conv._qat`` (module docstring).  Without ``act_amax`` the layer runs
    float in ``freeze`` and ``int8``, as JAX's does.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mode = 'off'
        # Set by models/layers.py:remat while it recomputes a forward.
        self.recomputing = False
        for key in QUANT_KEYS:
            self.register_buffer(key, None, persistent=False)

    def _apply(self, fn, recurse=True):
        # The quant buffers follow the weight's device and keep their own
        # dtype and layout: a cast of the model must not round act_amax
        # or w_scale to bf16.
        kept = {k: self._buffers[k] for k in QUANT_KEYS}
        for k in QUANT_KEYS:
            self._buffers[k] = None
        super()._apply(fn, recurse)
        for k, v in kept.items():
            self._buffers[k] = None if v is None else v.to(self.weight.device)
        return self

    def set_weights(self, w8: torch.Tensor, w_scale: torch.Tensor) -> None:
        """Store frozen int8 weights (OIHW) in the kernel's channels_last
        layout, and their f32 scales."""
        dev = self.weight.device
        self.w8 = w8.to(device=dev, dtype=torch.int8).contiguous(
            memory_format=torch.channels_last)
        self.w_scale = w_scale.to(device=dev, dtype=torch.float32)

    def record_amax(self, x) -> torch.Tensor:
        """``calib``: the running max of max|x|; ``qat``: its EMA
        ``0.99 a + 0.01 max|x|`` (the first batch sets it), left as it is
        while a remat recomputes (it already holds this step's value).
        Returns the new ``act_amax``."""
        if self.mode == 'qat' and self.recomputing:
            return self.act_amax
        amax = x.detach().abs().amax().float()
        if self.act_amax is None:
            self.act_amax = amax
        elif self.mode == 'calib':
            self.act_amax = torch.maximum(self.act_amax, amax)
        else:
            a = self.act_amax
            self.act_amax = torch.where(a > 0, 0.99 * a + 0.01 * amax, amax)
        return self.act_amax

    def forward(self, x):
        if self.mode == 'calib':
            self.record_amax(x)
            return super().forward(x)
        if self.mode == 'qat':
            return self._qat(x)
        if self.mode == 'off' or self.act_amax is None:
            return super().forward(x)
        if self.mode == 'freeze':
            self.set_weights(*quantize_weights(self.weight.detach()))
            return super().forward(x)
        return self._int8(x)

    def _qat(self, x):
        """Fake-quantized operands (quantize -> dequantize, straight-
        through gradient), the conv in float, the bias added, the result
        in x's dtype.  The scales multiply by float32(1/127) as jitted
        JAX does (``ops/qconv.py``)."""
        sx = torch.clamp_min(self.record_amax(x), 1e-6) * INV_127
        w = self.weight
        dims = tuple(range(1, w.dim()))
        sw = torch.clamp_min(w.detach().float().abs().amax(dim=dims)
                             * INV_127, 1e-12)
        xq = _fake_quant(x, sx)
        wq = _fake_quant(w, sw.view(-1, *(1,) * len(dims)))
        dt = torch.promote_types(xq.dtype, wq.dtype)
        y = self._conv_forward(xq.to(dt), wq.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y.to(x.dtype)

    def _int8(self, x):
        x8, sx = quantize_act(x, self.act_amax)
        if self.w8 is not None:
            w8, sw = self.w8, self.w_scale
        else:                       # not frozen: quantize in the graph
            w8, sw = quantize_weights(self.weight.detach())
        scale = sx * sw
        if qconv_eligible(self):
            shift = (self.bias.float() if self.bias is not None else
                     torch.zeros_like(scale))
            cl = torch.channels_last
            return qconv3x3(x8.contiguous(memory_format=cl),
                            w8.contiguous(memory_format=cl), scale, shift,
                            relu=False, out_dtype=x.dtype)
        y = F.conv2d(x8.float(), w8.float(), None, self.stride, self.padding,
                     self.dilation, self.groups)
        y = y * scale.view(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.float().view(1, -1, 1, 1)
        return y.to(x.dtype)


def _fake_quant(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(v / s), -127, 127) * s`` in f32, cast to v's dtype,
    with the identity as its gradient (JAX ``Conv._qat``'s
    ``fake_quant``)."""
    q = torch.clamp(torch.round(v.float() / s), -127, 127) * s
    return v + (q.to(v.dtype) - v).detach()


def _qconvs(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QConv2d)]


def set_mode(model: nn.Module, mode: str) -> None:
    """Put every :class:`QConv2d` of ``model`` in ``mode``."""
    if mode not in MODES:
        raise ValueError(f'quant mode {mode!r} not in {MODES}')
    for _, m in _qconvs(model):
        m.mode = mode


@torch.no_grad()
def calibrate_model(model: nn.Module, run: Callable, batches: Sequence,
                    freeze_index: int = -1) -> Dict[str, torch.Tensor]:
    """PTQ calibration: ``run(batch)`` (a forward of ``model``) over every
    batch in ``calib`` mode, then over ``batches[freeze_index]`` in
    ``freeze`` mode (the int8 weights depend on the weights alone, so
    one pass suffices).  Returns :func:`quant_state`; the model is left
    in ``freeze`` mode."""
    if not batches:
        raise ValueError('calibration needs at least one batch')
    set_mode(model, 'calib')
    for batch in batches:
        run(batch)
    set_mode(model, 'freeze')
    run(batches[freeze_index])
    return quant_state(model)


def quant_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{'<module>.act_amax' | '.w8' | '.w_scale': tensor}`` of every
    QConv2d that holds them (the JAX ``quant`` collection)."""
    return {f'{name}.{k}': getattr(m, k) for name, m in _qconvs(model)
            for k in QUANT_KEYS if getattr(m, k) is not None}


def load_quant_state(model: nn.Module,
                     state: Mapping[str, torch.Tensor]) -> None:
    """Set every QConv2d's quant buffers from ``state`` (a layer absent
    from it is left uncalibrated, so it runs float); raises on a key that
    names no QConv2d buffer or on ``w8`` without ``w_scale``."""
    by_name = dict(_qconvs(model))
    unknown = [k for k in state if k.rpartition('.')[0] not in by_name
               or k.rpartition('.')[2] not in QUANT_KEYS]
    if unknown:
        raise KeyError(f'quant state keys that name no QConv2d: {unknown}')
    for name, m in by_name.items():
        amax = state.get(f'{name}.act_amax')
        m.act_amax = (None if amax is None else amax.to(
            device=m.weight.device, dtype=torch.float32))
        w8, sw = state.get(f'{name}.w8'), state.get(f'{name}.w_scale')
        if (w8 is None) != (sw is None):
            raise KeyError(f'{name}: w8 and w_scale come together')
        m.w8 = m.w_scale = None
        if w8 is not None:
            m.set_weights(w8, sw)
