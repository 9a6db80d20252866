"""Conv+BN fusion for deployment checkpoints (counterpart of
``omnihd_scenes_tpu/serve/fuse.py``).

Pairing is dataflow-exact, as in JAX: :func:`trace_pairs` runs one
eval-mode forward with forward hooks on every ``nn.Conv2d`` (``QConv2d``
included), ``nn.ConvTranspose2d`` and ``nn.Linear`` and forward pre-hooks
on every :class:`~omnihd_scenes_tpu_torch.models.layers.BatchNorm`, and
pairs a BN with a producer when the BN's input *is* that producer's
output.  One relaxation, for the pillar PFN (a ``Linear`` over (..., C)
points whose BN normalises the (N, C) reshape; JAX's BN takes the Dense
output as it is): a 2-D view of a ``Linear`` output that keeps its last
axis pairs too, since the fold is per output feature either way.  The
space-to-depth stem is not a conv to the trace (JAX's ``S2DStem`` is no
``nn.Conv`` either).  The trace records each BN's epsilon (``BN_EPS`` or
``FLAX_BN_EPS``).

Folding, in f32: ``s_f = weight / sqrt(var + eps)``; the producer's weight
is scaled along its output-channel axis (dim 0 of ``Conv2d`` and
``Linear`` weights, dim 1 of a ``ConvTranspose2d``'s (in, out/groups, kh,
kw)), its bias by ``s_f``; the BN stays as a passthrough plus bias:
weight K = 1e4, var K^2, mean 0, bias ``b - s_f * m``, so the checkpoint
keeps its keys.  The passthrough is exact in f32 only: in bf16 K rounds
to 9984 and K^2 to 100139008, a gain of 0.99771.  So a server folds the
passthrough into its producer first (:func:`fold_passthroughs`, called by
``Predictor`` and ``serve/export.py`` before they cast the model), as XLA
folds it into the conv at compile time in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from omnihd_scenes_tpu_torch.models.layers import BatchNorm
from omnihd_scenes_tpu_torch.models.resnet import S2DStem

K = 1e4           # passthrough scale: K / sqrt(K^2 + eps) == 1.0 in f32

_PRODUCERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _is_producer(m: nn.Module) -> bool:
    return isinstance(m, _PRODUCERS) and not isinstance(m, S2DStem)


def _is_output_of(x, out, linear: bool) -> bool:
    if x is out:
        return True
    # A 2-D view of a Linear's output over its last axis (the PFN).
    return (linear and x.dim() == 2 and x._base is not None
            and x._base is (out if out._base is None else out._base)
            and x.shape[-1] == out.shape[-1] and x.numel() == out.numel())


def trace_pairs(run: Callable, model: nn.Module
                ) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Call ``run()`` (one forward of ``model``) once in eval mode, with
    gradients off but outside ``torch.inference_mode``, and return (BN
    module name -> producer module name, BN module name -> epsilon)."""
    produced: Dict[int, tuple] = {}   # id(out) -> (out, name, is Linear)
    pairs: Dict[str, str] = {}
    eps: Dict[str, float] = {}
    handles = []

    def producer_hook(name, linear):
        def hook(module, args, out):
            # Keep a reference so the ids stay unique for the trace.
            produced[id(out)] = (out, name, linear)
            if linear and out._base is not None:
                produced[id(out._base)] = (out, name, linear)
        return hook

    def bn_hook(name):
        def hook(module, args):
            x = args[0]
            eps[name] = float(module.eps)
            for key in (id(x), id(x._base)):
                hit = produced.get(key)
                if hit is not None and _is_output_of(x, hit[0], hit[2]):
                    pairs[name] = hit[1]
                    return
        return hook

    for name, m in model.named_modules():
        if _is_producer(m):
            handles.append(m.register_forward_hook(
                producer_hook(name, isinstance(m, nn.Linear))))
        elif isinstance(m, BatchNorm):
            handles.append(m.register_forward_pre_hook(bn_hook(name)))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return pairs, eps


def _out_channels(producer: nn.Module) -> int:
    if isinstance(producer, nn.Linear):
        return producer.out_features
    return producer.out_channels


def fuse_conv_bn(state_dict: Dict[str, torch.Tensor], pairs: Dict[str, str],
                 bn_eps: Dict[str, float], model: nn.Module
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """Fold each paired BN into its producer's weight, in f32.  ``model``
    gives the producers' kinds.  Returns (fused state dict, report) with
    ``fused`` / ``skipped`` lists of BN names (skips with JAX's reasons)."""
    sd = {k: v.detach().clone() for k, v in state_dict.items()}
    modules = dict(model.named_modules())
    fused, skipped = [], []
    # A producer consumed by more than one BN must not be folded: each
    # fold rescales the shared weight again, corrupting every consumer.
    counts: Dict[str, int] = {}
    for lin in pairs.values():
        counts[lin] = counts.get(lin, 0) + 1
    for bn, lin in sorted(pairs.items()):
        producer = modules[lin]
        if counts[lin] > 1:
            skipped.append(bn + ' (producer feeds multiple BNs)')
            continue
        if f'{bn}.weight' not in sd:
            skipped.append(bn + ' (no affine params)')
            continue
        if f'{bn}.running_mean' not in sd:
            skipped.append(bn + ' (no running stats)')
            continue
        if _out_channels(producer) != sd[f'{bn}.weight'].shape[0]:
            skipped.append(bn + ' (producer kernel mismatch)')
            continue
        scale = sd[f'{bn}.weight'].float()
        mean = sd[f'{bn}.running_mean'].float()
        var = sd[f'{bn}.running_var'].float()
        # var + eps in f32, then a correctly rounded square root (taken in
        # f64: PyTorch's vectorised f32 sqrt on the CPU is not, NumPy's
        # and XLA's are), then the f32 division.
        root = torch.sqrt((var + np.float32(bn_eps[bn])).double()).float()
        s_f = scale / root
        w = sd[f'{lin}.weight']
        axis = 1 if isinstance(producer, nn.ConvTranspose2d) else 0
        shape = [1] * w.dim()
        shape[axis] = -1
        sd[f'{lin}.weight'] = (w.float() * s_f.view(shape)).to(w.dtype)
        if f'{lin}.bias' in sd:
            b = sd[f'{lin}.bias']
            sd[f'{lin}.bias'] = (b.float() * s_f).to(b.dtype)
        sd[f'{bn}.bias'] = sd[f'{bn}.bias'].float() - s_f * mean
        sd[f'{bn}.weight'] = torch.full_like(scale, K)
        sd[f'{bn}.running_mean'] = torch.zeros_like(mean)
        sd[f'{bn}.running_var'] = torch.full_like(var, K * K)
        fused.append(bn)
    return sd, {'fused': fused, 'skipped': skipped}


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    return [t for o in (out or ()) for t in _outputs(o)]


def fuse_model(model: nn.Module, run: Callable, verify: bool = True,
               atol: float = 1e-3, rtol: float = 1e-3
               ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Trace + fuse: ``run()`` is one forward of ``model`` with the
    weights it holds.  With ``verify`` the forward is re-run on the fused
    weights and every output held to the original's, the backstop for
    consumers the trace cannot see (a conv output feeding a residual path
    as well as its BN); raises ``ValueError`` on a deviation.  Returns
    (fused state dict, report); ``model`` keeps its own weights."""
    original = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pairs, eps = trace_pairs(run, model)
    fused, report = fuse_conv_bn(original, pairs, eps, model)
    if verify and report['fused']:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                ref = [t.float().clone() for t in _outputs(run())]
                model.load_state_dict(fused)
                out = [t.float() for t in _outputs(run())]
        finally:
            model.load_state_dict(original)
            model.train(was_training)
        for r, o in zip(ref, out):
            if not torch.allclose(o, r, atol=atol, rtol=rtol,
                                  equal_nan=True):
                raise ValueError(
                    'fuse_model verification failed: fused forward '
                    f'deviates by {float((o - r).abs().max()):.3e} - a '
                    'folded conv output likely has a consumer besides its '
                    'BN')
        report['verified'] = True
    return fused, report


def passthrough_bns(model: nn.Module) -> List[str]:
    """Names of the BNs that a fused checkpoint left as passthroughs
    (weight K, mean 0, var K^2), read where the model is now: call it
    while the model is on the host."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm) and m.weight is not None \
                and m.running_mean is not None \
                and bool((m.weight == K).all()) \
                and bool((m.running_mean == 0).all()) \
                and bool((m.running_var == K * K).all()):
            out.append(name)
    return out


@torch.no_grad()
def fold_passthroughs(model: nn.Module, names: List[str],
                      run: Callable) -> List[str]:
    """Fold the passthrough BNs ``names`` (:func:`passthrough_bns`) into
    their producers, in the model's dtype (f32): the BN's bias becomes
    the producer's bias (added to it, or a new one) and the BN an
    ``nn.Identity``.  ``run()`` is one forward of ``model``, traced to find
    the producers.  Returns the names folded; a passthrough whose
    producer the trace does not find stays a BN."""
    if not names:
        return []
    pairs, _ = trace_pairs(run, model)
    modules = dict(model.named_modules())
    folded = []
    for name in names:
        lin = pairs.get(name)
        if lin is None or list(pairs.values()).count(lin) > 1:
            continue
        producer, bn = modules[lin], modules[name]
        bias = bn.bias.detach().to(producer.weight.dtype)
        if producer.bias is None:
            producer.bias = nn.Parameter(bias.clone())
        else:
            producer.bias.add_(bias)
        parent, _, attr = name.rpartition('.')
        setattr(modules[parent] if parent else model, attr, nn.Identity())
        folded.append(name)
    return folded
