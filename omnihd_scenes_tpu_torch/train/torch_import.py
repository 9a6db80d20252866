"""Torch checkpoints -> the port's models: pretrained backbones and
mm-style detector checkpoints (counterpart of
``omnihd_scenes_tpu/train/torch_import.py``).

Parity target: the reference's partial-checkpoint loaders
(``tools/train.py:276-428``), which chain-load ImageNet ResNets and staged
single-modality ``.pth`` checkpoints into the fusion models
(``load_img_from`` with backbone -> img_backbone style renames and per-key
verification), and the implicit torchvision ``pretrained=True`` ImageNet
init of every camera baseline.

The port's ResNet keeps torchvision's names and layouts, so an import is a
rename and a shape check, with no transpose; everything works on
``state_dict``s (``{key: tensor}``):

* :func:`load_state_dict` reads a ``.pth`` (``torch.load(...,
  weights_only=True)``; the mm-style ``{'state_dict': ...}`` and the
  port's own ``{'model': ...}`` checkpoints unwrapped; ``module.`` DDP
  prefixes stripped) or a ``.npz``;
* :func:`import_torchvision_resnet` maps torchvision ResNet-18/34/50/101
  keys through ``weights.resnet_name_map`` onto the model's backbone;
* :func:`import_by_rules` maps prefixed keys by rename rules;
* :func:`apply_pretrained` wires the config keys ``pretrained`` and
  ``load_img_from`` to them.

The reports (loaded, missing, mismatched, unused / skipped) list the same
torch keys as the JAX package's for a torchvision checkpoint of a ResNet
without DCN.  Three departures, where the JAX package cannot find
torchvision's names: a ``stage_with_dcn`` ResNet loads the DCN stages' 3x3
kernels (JAX reports them missing); :func:`import_by_rules` resolves the
rest of a key below its rule's prefix by the port's own (torchvision)
names, so an mm-style ``backbone.layer1.0.conv1.weight`` loads where the
JAX package's literal flax path finds no ``layer1``; and
:func:`find_backbone_prefix` finds the ResNet by its torchvision keys,
where the JAX package's structural search (a ``Conv_0`` beside a
``BasicBlock_0``) takes BEVFusion's DepthNet, which comes first in its
tree.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from omnihd_scenes_tpu_torch.weights import resnet_name_map

StateDict = Dict[str, torch.Tensor]
_SKIP = 'num_batches_tracked'

# Reference rename policies (tools/train.py:276-428): mm-style prefix ->
# the port's module prefix ('backbone' is retargeted onto the model's
# ResNet by apply_pretrained).
LOAD_IMG_FROM_RULES = (
    ('backbone', 'img_backbone'),
    ('neck', 'img_neck'),
    ('img_backbone', 'img_backbone'),
    ('img_neck', 'img_neck'),
)


def load_state_dict(path: str) -> StateDict:
    """Read a torch ``.pth`` (or ``.npz``) into {key: CPU tensor}."""
    if path.endswith('.npz'):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    else:
        obj = torch.load(path, map_location='cpu', weights_only=True)
        for wrapper in ('state_dict', 'model'):
            if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
                obj = obj[wrapper]
        sd = {k: v for k, v in obj.items() if torch.is_tensor(v)}
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in sd.items()}


def import_torchvision_resnet(sd: StateDict, depth: int, target: StateDict,
                              prefix: str = '',
                              verbose: bool = True) -> Tuple[StateDict, Dict]:
    """Merge a torchvision ResNet state_dict into ``target`` (a model's
    state_dict, the backbone under ``prefix``; shapes verified).

    Returns (state_dict, report): the report lists the torchvision keys
    loaded, missing (from ``sd`` or from the target), mismatched in shape,
    and unused (``fc.*`` and step counters aside).
    """
    nmap = resnet_name_map(depth)
    out = dict(target)
    loaded, mismatched, missing = [], [], []
    for tkey in nmap:
        key = prefix + tkey
        if tkey not in sd or key not in target:
            missing.append(tkey)
            continue
        value = sd[tkey]
        if tuple(target[key].shape) != tuple(value.shape):
            mismatched.append(tkey)
            continue
        out[key] = value.detach().to(torch.float32).clone()
        loaded.append(tkey)
    unused = [k for k in sd if k not in nmap and not k.startswith('fc.')
              and not k.endswith(_SKIP)]
    report = {'loaded': loaded, 'missing': missing,
              'mismatched': mismatched, 'unused': unused}
    if verbose:
        print(f'[torch_import] resnet{depth}: {len(loaded)} loaded, '
              f'{len(missing)} missing, {len(mismatched)} mismatched, '
              f'{len(unused)} unused torch keys')
    return out, report


def import_by_rules(target: StateDict, sd: StateDict,
                    rules: Sequence[Tuple[str, str]],
                    drop_prefixes: Sequence[str] = (),
                    verbose: bool = True) -> Tuple[StateDict, Dict]:
    """Merge ``sd`` into ``target`` by prefix rules.

    Each rule ``(torch_prefix, port_prefix)`` claims the keys starting
    with ``torch_prefix``; the rest of the key, below ``port_prefix``,
    names the target tensor.  Only tensors of the target's shape load;
    everything else is reported.
    """
    out = dict(target)
    loaded, skipped, mismatched = [], [], []
    for tkey, value in sd.items():
        if tkey.endswith(_SKIP) or any(tkey.startswith(d)
                                       for d in drop_prefixes):
            continue
        match = None
        for torch_prefix, port_prefix in rules:
            if tkey.startswith(torch_prefix):
                rest = tkey[len(torch_prefix):].lstrip('.')
                cand = f'{port_prefix}.{rest}' if port_prefix else rest
                if cand in target:
                    match = cand
                    break
        if match is None:
            skipped.append(tkey)
            continue
        if tuple(value.shape) != tuple(target[match].shape):
            mismatched.append(f'{tkey}: {tuple(value.shape)} -> '
                              f'{tuple(target[match].shape)}')
            continue
        out[match] = value.detach().to(torch.float32).clone()
        loaded.append(tkey)
    n_target = sum(not k.endswith(_SKIP) for k in target)
    report = {'loaded': loaded, 'skipped': skipped, 'mismatched': mismatched,
              'coverage': len(loaded) / max(n_target, 1)}
    if verbose:
        print(f'[torch_import] rules: {len(loaded)}/{n_target} target '
              f'leaves loaded, {len(skipped)} torch keys unmatched, '
              f'{len(mismatched)} shape mismatches')
        for m in mismatched[:20]:
            print(f'[torch_import]   mismatch {m}')
    return out, report


def find_backbone_prefix(state_dict: StateDict) -> Optional[str]:
    """The key prefix of the model's ResNet (``''`` for a bare one,
    ``'resnet.'`` in BEVFusion, ``'img_backbone.'`` in BEVFormer-T), found
    by its stem and first block; None if the model has none."""
    tail = 'layer1.0.conv1.weight'
    for key in state_dict:
        if key.endswith(tail):
            prefix = key[:-len(tail)]
            if f'{prefix}conv1.weight' in state_dict:
                return prefix
    return None


def _looks_like_torchvision_resnet(sd: StateDict) -> bool:
    return 'conv1.weight' in sd and any(k.startswith('layer1.') for k in sd)


def resolve_pretrained_path(spec: str) -> str:
    """A ``pretrained=`` spec -> a local checkpoint path.

    ``torchvision://resnet50`` (the reference's implicit ImageNet init)
    resolves against the local torch-hub cache (``$TORCH_HOME``, default
    ``~/.cache/torch``): nothing is downloaded.  Any other spec is a path.
    """
    if not spec.startswith('torchvision://'):
        return spec
    name = spec[len('torchvision://'):]
    hub = os.environ.get('TORCH_HOME', os.path.expanduser('~/.cache/torch'))
    hits = sorted(glob.glob(os.path.join(hub, 'hub', 'checkpoints',
                                         f'{name}-*.pth')))
    if not hits:
        raise FileNotFoundError(
            f'{spec}: no cached torchvision weights under '
            f'{hub}/hub/checkpoints (nothing is downloaded: place the .pth '
            f'there or use load_img_from=<path>)')
    return hits[-1]


def _infer_depth(sd: StateDict) -> int:
    """ResNet depth from a torchvision state_dict's block counts."""
    idx = [int(m.group(1)) for k in sd
           for m in [re.match(r'layer4\.(\d+)\.', k)] if m]
    n4 = max(idx) + 1 if idx else 0
    if not any('.bn3.' in k for k in sd):
        return {2: 18, 3: 34}.get(n4, 34)
    return 101 if any(k.startswith('layer3.22.') for k in sd) else 50


def apply_pretrained(state_dict: StateDict, *,
                     pretrained: Optional[str] = None,
                     load_img_from: Optional[str] = None,
                     resnet_depth: Optional[int] = None,
                     verbose: bool = True) -> Tuple[StateDict, Dict]:
    """The config keys ``pretrained`` (``torchvision://resnet50`` or a
    path to a torchvision ResNet) and ``load_img_from`` (a torchvision
    ResNet, or an mm-style detector checkpoint whose ``backbone`` /
    ``neck`` keys rename onto the model's backbone / ``img_neck``) applied
    to a model's ``state_dict``.  Returns (merged state_dict, {key:
    report}).
    """
    reports: Dict[str, Dict] = {}
    prefix = find_backbone_prefix(state_dict)
    if pretrained:
        sd = load_state_dict(resolve_pretrained_path(pretrained))
        if not _looks_like_torchvision_resnet(sd):
            raise ValueError(f'pretrained={pretrained}: not a torchvision '
                             f'ResNet state dict')
        depth = resnet_depth
        if depth is None and pretrained.startswith('torchvision://'):
            m = re.search(r'resnet(\d+)', pretrained)
            depth = int(m.group(1)) if m else None
        if depth is None:
            raise ValueError(f'resnet_depth required to import '
                             f'pretrained={pretrained}')
        if prefix is None:
            raise ValueError('no ResNet backbone found in the model to '
                             'receive pretrained weights')
        state_dict, reports['pretrained'] = import_torchvision_resnet(
            sd, depth, target=state_dict, prefix=prefix, verbose=verbose)
    if load_img_from:
        sd = load_state_dict(load_img_from)
        if _looks_like_torchvision_resnet(sd):
            if prefix is None:
                raise ValueError('no ResNet backbone found in the model for '
                                 'load_img_from')
            state_dict, reports['load_img_from'] = import_torchvision_resnet(
                sd, resnet_depth or _infer_depth(sd), target=state_dict,
                prefix=prefix, verbose=verbose)
        else:
            rules = LOAD_IMG_FROM_RULES
            if prefix is not None and prefix != 'img_backbone.':
                rules = tuple((t, prefix.rstrip('.'))
                              if p == 'img_backbone' else (t, p)
                              for t, p in LOAD_IMG_FROM_RULES)
            state_dict, reports['load_img_from'] = import_by_rules(
                state_dict, sd, rules, verbose=verbose)
    return state_dict, reports
