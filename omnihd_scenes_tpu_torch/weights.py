"""Weights between the JAX package's flax variables and the port.

:func:`flax_to_torch` turns flax ``{'params', 'batch_stats'}`` (NumPy or
JAX arrays) into a ``state_dict`` of
:class:`omnihd_scenes_tpu_torch.models.bevfusion.BEVFusion` (any of its
ported configurations) or, given a ``PointPillarsConfig``, of
:class:`omnihd_scenes_tpu_torch.models.detectors.PointPillars`;
:func:`torch_to_flax` goes back.  Layouts: conv HWIO <-> OIHW;
ConvTranspose (kh, kw, in, out) <-> (in, out, kh, kw) flipped in both
spatial dims (flax's ``ConvTranspose`` does not transpose its kernel,
torch's ``conv_transpose2d`` does); Dense (in, out) <-> (out, in); BatchNorm scale/bias/mean/var <->
weight/bias/running_mean/running_var.  Each torch BatchNorm carries its
flax module's epsilon (see ``models/layers.py``).  The ResNet part is the
JAX package's ``train/torch_import.resnet_name_map``, restated here so
the port imports nothing of the JAX package.

:func:`flax_tree_to_torch` carries one collection of such a tree (a
gradient tree is shaped like ``params``) into the same torch names.

:func:`flax_quant_to_torch` / :func:`torch_quant_to_flax` carry the int8
``quant`` collection: a conv whose kernel is ``('params', *p, 'kernel')``
keeps ``act_amax`` / ``w8`` / ``w_scale`` at ``('quant', *p, leaf)`` and
in the port as ``<module>.<leaf>`` (``models/quant.py:quant_state``);
``w8`` goes HWIO <-> OIHW and stays int8, the scales stay f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import BEVFusionConfig, PointPillarsConfig
from omnihd_scenes_tpu_torch.models.lss import ASPP
from omnihd_scenes_tpu_torch.models.quant import QUANT_KEYS
from omnihd_scenes_tpu_torch.models.resnet import ARCHS, Bottleneck

FlaxPath = Tuple[str, ...]            # (collection, module, ..., leaf)
ModelConfig = Union[BEVFusionConfig, PointPillarsConfig]


class _NameMap:
    """Collects torch key -> flax path pairs, one module kind at a time."""

    def __init__(self):
        self.pairs: Dict[str, FlaxPath] = {}

    def conv(self, t: str, f: FlaxPath, bias: bool = False):
        self.pairs[f'{t}.weight'] = ('params',) + f + ('kernel',)
        if bias:
            self.pairs[f'{t}.bias'] = ('params',) + f + ('bias',)

    def bn(self, t: str, f: FlaxPath):
        for tk, coll, fk in (('weight', 'params', 'scale'),
                             ('bias', 'params', 'bias'),
                             ('running_mean', 'batch_stats', 'mean'),
                             ('running_var', 'batch_stats', 'var')):
            self.pairs[f'{t}.{tk}'] = (coll,) + f + (fk,)

    def conv_bn(self, t: str, f: FlaxPath, conv: str = 'conv'):
        """A ConvBNReLU / DeconvBNReLU block."""
        kind = 'ConvTranspose_0' if conv == 'deconv' else 'Conv_0'
        self.conv(f'{t}.{conv}', f + (kind,))
        self.bn(f'{t}.bn', f + ('BatchNorm_0',))


def resnet_name_map(depth: int) -> Dict[str, FlaxPath]:
    """torchvision ResNet key -> flax (collection, *path).

    Flax numbers the blocks flat: ``layer{s}.{j}`` is block
    ``sum(blocks[:s-1]) + j``; within a block conv/bn ``c`` is
    ``Conv_{c-1}`` / ``BatchNorm_{c-1}`` and the downsample pair is
    declared last.
    """
    block, stage_blocks = ARCHS[depth]
    n_convs = 3 if block is Bottleneck else 2
    m = _NameMap()
    m.conv('conv1', ('Conv_0',))
    m.bn('bn1', ('BatchNorm_0',))
    idx = 0
    for s, n_blocks in enumerate(stage_blocks):
        for j in range(n_blocks):
            t, f = f'layer{s + 1}.{j}', (f'{block.__name__}_{idx}',)
            for c in range(n_convs):
                m.conv(f'{t}.conv{c + 1}', f + (f'Conv_{c}',))
                m.bn(f'{t}.bn{c + 1}', f + (f'BatchNorm_{c}',))
            if j == 0 and (s > 0 or block is Bottleneck):
                m.conv(f'{t}.downsample.0', f + (f'Conv_{n_convs}',))
                m.bn(f'{t}.downsample.1', f + (f'BatchNorm_{n_convs}',))
            idx += 1
    return m.pairs


def name_map(cfg: ModelConfig) -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for BEVFusion, or
    for PointPillars when ``cfg`` is a ``PointPillarsConfig``.  The
    pillar, ``fuse`` and ``se`` keys exist only in the configurations
    that build those modules."""
    if isinstance(cfg, PointPillarsConfig):
        return pointpillars_name_map(cfg)
    m = _NameMap()
    for tkey, path in resnet_name_map(cfg.resnet_depth).items():
        m.pairs[f'resnet.{tkey}'] = (path[0], 'ResNet_0') + tuple(path[1:])

    n_levels = len(cfg.resnet_out_indices)
    fpnc = ('FPNC_0',)
    for i in range(n_levels):
        m.conv(f'fpnc.fpn.lateral_convs.{i}', fpnc + ('FPN_0', f'Conv_{i}'),
               bias=True)
        m.conv(f'fpnc.fpn.fpn_convs.{i}',
               fpnc + ('FPN_0', f'Conv_{n_levels + i}'), bias=True)
    m.conv('fpnc.reduce_conv', fpnc + ('Conv_0',))
    m.bn('fpnc.bn', fpnc + ('BatchNorm_0',))

    lss = ('LiftSplatShoot_0',)
    if cfg.use_depthnet:
        dn = lss + ('DepthNet_0',)
        m.conv_bn('lss.depthnet.reduce', dn + ('ConvBNReLU_0',))
        m.conv('lss.depthnet.context_conv', dn + ('Conv_0',), bias=True)
        for i in range(3):
            blk = dn + (f'BasicBlock_{i}',)
            for c in range(2):
                m.conv(f'lss.depthnet.blocks.{i}.conv{c + 1}',
                       blk + (f'Conv_{c}',))
                m.bn(f'lss.depthnet.blocks.{i}.bn{c + 1}',
                     blk + (f'BatchNorm_{c}',))
        aspp = dn + ('ASPP_0',)
        n_br = len(ASPP.DILATIONS)
        for i in range(n_br):
            m.conv(f'lss.depthnet.aspp.convs.{i}', aspp + (f'Conv_{i}',))
            m.bn(f'lss.depthnet.aspp.bns.{i}', aspp + (f'BatchNorm_{i}',))
        m.conv('lss.depthnet.aspp.pool_conv', aspp + (f'Conv_{n_br}',))
        m.bn('lss.depthnet.aspp.pool_bn', aspp + (f'BatchNorm_{n_br}',))
        m.conv('lss.depthnet.aspp.project', aspp + (f'Conv_{n_br + 1}',))
        m.bn('lss.depthnet.aspp.project_bn',
             aspp + (f'BatchNorm_{n_br + 1}',))
        m.conv('lss.depthnet.depth_conv', dn + ('Conv_1',), bias=True)
    else:
        m.conv('lss.cam_encode.conv', lss + ('CamEncode_0', 'Conv_0'),
               bias=True)
    for i in range(4):
        m.conv_bn(f'lss.bev_encoder.layers.{i}',
                  lss + ('BevEncoderConvs_0', f'ConvBNReLU_{i}'))

    if cfg.radar_stream:
        _pillar_block(m, cfg.pillars)
    if cfg.lc_fusion and cfg.radar_stream:
        m.conv_bn('fuse', ('ConvBNReLU_0',))
        if cfg.se:
            m.conv('se.conv', ('SEBlock_0', 'Conv_0'), bias=True)
    _head(m)
    return m.pairs


def _pillar_block(m: _NameMap, pc: PointPillarsConfig):
    """The pillar stream; flax keeps it at the top level of both
    PointPillars and BEVFusion."""
    for i in range(len(pc.pfn_channels)):
        pfn = ('PillarFeatureNet_0', f'PFNLayer_{i}')
        m.pairs[f'pillar_encoder.pfn.{i}.linear.weight'] = (
            ('params',) + pfn + ('Dense_0', 'kernel'))
        m.bn(f'pillar_encoder.pfn.{i}.bn', pfn + ('BatchNorm_0',))
    li = 0                               # flax numbers SECOND's convs flat
    for s, num in enumerate(pc.second_layer_nums):
        for j in range(num + 1):
            m.conv_bn(f'second.blocks.{s}.{j}', ('SECOND_0', f'ConvBNReLU_{li}'))
            li += 1
    for i in range(len(pc.fpn_strides)):
        m.conv_bn(f'second_fpn.deblocks.{i}',
                  ('SECONDFPN_0', f'DeconvBNReLU_{i}'), conv='deconv')


def _head(m: _NameMap):
    for i, name in enumerate(('conv_cls', 'conv_reg', 'conv_dir')):
        m.conv(f'head.{name}', ('Anchor3DHead_0', f'Conv_{i}'), bias=True)


def pointpillars_name_map(cfg: PointPillarsConfig) -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for PointPillars
    (and RadarPillarNet)."""
    m = _NameMap()
    _pillar_block(m, cfg)
    _head(m)
    return m.pairs


def _is_deconv(path: FlaxPath) -> bool:
    return path[-2].startswith('ConvTranspose')


def _flax_to_torch_layout(v: np.ndarray, path: FlaxPath) -> np.ndarray:
    if v.ndim == 4 and _is_deconv(path):
        return v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if v.ndim == 4:
        return v.transpose(3, 2, 0, 1)
    return v.T if v.ndim == 2 else v


def _torch_to_flax_layout(v: np.ndarray, path: FlaxPath) -> np.ndarray:
    if v.ndim == 4 and _is_deconv(path):
        return v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if v.ndim == 4:
        return v.transpose(2, 3, 1, 0)
    return v.T if v.ndim == 2 else v


def flax_to_torch(variables, cfg: ModelConfig,
                  collections=('params', 'batch_stats')
                  ) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` -> torch state_dict (f32)."""
    sd = {}
    for tkey, path in name_map(cfg).items():
        if path[0] not in collections:
            continue
        v = variables
        for k in path:
            v = v[k]
        v = _flax_to_torch_layout(np.asarray(v, np.float32), path)
        sd[tkey] = torch.from_numpy(v.copy(order='C'))
    return sd


def flax_tree_to_torch(tree, cfg: ModelConfig,
                       collection: str = 'params') -> Dict[str, torch.Tensor]:
    """One flax collection's content (e.g. a gradient tree shaped like
    ``params``, or new ``batch_stats``) -> {torch key: f32 tensor} in the
    torch layouts, for the keys of that collection."""
    return flax_to_torch({collection: tree}, cfg, collections=(collection,))


def torch_to_flax(state_dict, cfg: ModelConfig) -> Dict:
    """Torch state_dict -> flax ``{'params', 'batch_stats'}`` (NumPy)."""
    out: Dict = {}
    for tkey, path in name_map(cfg).items():
        v = state_dict[tkey].detach().cpu().float().numpy()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _torch_to_flax_layout(v, path).copy(order='C')
    return out


def _conv_modules(cfg: ModelConfig) -> Dict[FlaxPath, str]:
    """flax module path -> torch module name, for every conv kernel."""
    return {path[1:-1]: tkey[:-len('.weight')]
            for tkey, path in name_map(cfg).items()
            if path[0] == 'params' and path[-1] == 'kernel'}


def _leaves(tree, prefix: FlaxPath = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def flax_quant_to_torch(quant, cfg: ModelConfig) -> Dict[str,
                                                             torch.Tensor]:
    """The flax ``quant`` collection (its content, NumPy or JAX arrays)
    -> the port's quant state (``models/quant.py:load_quant_state``)."""
    modules = _conv_modules(cfg)
    out = {}
    for path, v in _leaves(quant):
        mod, leaf = path[:-1], path[-1]
        if mod not in modules or leaf not in QUANT_KEYS:
            raise KeyError(f'quant leaf {path} names no conv of the model')
        v = np.asarray(v)
        if leaf == 'w8':
            if v.dtype != np.int8 or v.ndim != 4:
                raise TypeError(f'{path}: w8 must be a 4-d int8 kernel, got '
                                f'{v.dtype} {v.shape}')
            v = v.transpose(3, 2, 0, 1)
        else:
            v = v.astype(np.float32)
        out[f'{modules[mod]}.{leaf}'] = torch.from_numpy(v.copy(order='C'))
    return out


def torch_quant_to_flax(state, cfg: ModelConfig) -> Dict:
    """The port's quant state -> the flax ``quant`` collection's content
    (NumPy)."""
    paths = {name: mod for mod, name in _conv_modules(cfg).items()}
    out: Dict = {}
    for key, t in state.items():
        name, _, leaf = key.rpartition('.')
        if name not in paths or leaf not in QUANT_KEYS:
            raise KeyError(f'quant key {key!r} names no conv of the model')
        v = t.detach().cpu().numpy()
        if leaf == 'w8':
            v = v.transpose(2, 3, 1, 0)
        node = out
        for k in paths[name]:
            node = node.setdefault(k, {})
        node[leaf] = v.copy(order='C')
    return out


def load_state_dict(model: nn.Module, state_dict) -> None:
    """Strict load that tolerates only BatchNorm's step counters missing
    (flax keeps none)."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise KeyError(f'state_dict mismatch: missing {missing}, '
                       f'unexpected {unexpected}')


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (on the CPU): LeCun-normal conv
    and linear weights (flax's default init), zero biases, identity
    BatchNorms."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator)
                    * fan_in ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()
    return model
