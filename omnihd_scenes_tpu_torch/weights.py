"""Weights between the JAX package's flax variables and the port.

:func:`flax_to_torch` turns flax ``{'params', 'batch_stats'}`` (NumPy or
JAX arrays) into a ``state_dict`` of
:class:`omnihd_scenes_tpu_torch.models.bevfusion.BEVFusion` (any of its
ported configurations, RCFusion's included), given an ``MTLConfig`` of
:class:`omnihd_scenes_tpu_torch.models.mtl.BEVFusionMTL`, given a
``PointPillarsConfig`` of
:class:`omnihd_scenes_tpu_torch.models.detectors.PointPillars`, and given
an :class:`OccHeadSpec` of a bare occupancy head of
``models/occ_head.py``, given a ``BEVFormerConfig`` of
:class:`omnihd_scenes_tpu_torch.models.bevformer.BEVFormerDetector`, and
given a :class:`CenterHeadSpec` or an :class:`MMBEVFormerLayerSpec` of a
bare ``models/centerpoint_head.py:CenterHead`` or
``models/bevformer/encoder.py:MMBEVFormerLayer``;
:func:`torch_to_flax` goes back.  Layouts: conv
HWIO <-> OIHW, 3D conv DHWIO <-> OIDHW;
ConvTranspose (kh, kw, in, out) <-> (in, out, kh, kw) flipped in both
spatial dims (flax's ``ConvTranspose`` does not transpose its kernel,
torch's ``conv_transpose2d`` does); Dense (in, out) <-> (out, in); BatchNorm scale/bias/mean/var <->
weight/bias/running_mean/running_var; LayerNorm scale/bias <->
weight/bias; flax ``MultiHeadDotProductAttention``'s query / key / value
kernels (C, heads, head_dim) and biases (heads, head_dim) <-> ``Linear``
(heads * head_dim, C) and (heads * head_dim,), its out kernel (heads,
head_dim, C) <-> (C, heads * head_dim); embeddings as they are.  Each torch BatchNorm carries its
flax module's epsilon (see ``models/layers.py``).  A BEVFusion without
the camera stream has no ResNet, FPNC or LSS keys; a fractional SECONDFPN
stride is a strided conv, flax's ``Conv_0``.  The ResNet part is the
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

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from omnihd_scenes_tpu_torch.config import (BEVFormerConfig, BEVFusionConfig,
                                            MTLConfig, PointPillarsConfig)
from omnihd_scenes_tpu_torch.models.bevformer.attention import NUM_HEADS
from omnihd_scenes_tpu_torch.models.centerpoint_head import REG_BRANCHES
from omnihd_scenes_tpu_torch.models.dcn import DeformConv
from omnihd_scenes_tpu_torch.models.lss import ASPP
from omnihd_scenes_tpu_torch.models.quant import QUANT_KEYS
from omnihd_scenes_tpu_torch.models.resnet import ARCHS, Bottleneck

FlaxPath = Tuple[str, ...]            # (collection, module, ..., leaf)


class OccHeadSpec(NamedTuple):
    """A bare occupancy head, the flax module at the top of its tree:
    ``'2d'`` (``BEVOCCHead2D``) or ``'3d'`` (``BEVOCCHead3D``)."""

    kind: str = '2d'


class CenterHeadSpec(NamedTuple):
    """A bare ``CenterHead``, the flax module at the top of its tree."""


class MMBEVFormerLayerSpec(NamedTuple):
    """A bare ``MMBEVFormerLayer``, the flax module at the top of its
    tree."""


ModelConfig = Union[BEVFusionConfig, MTLConfig, PointPillarsConfig,
                    OccHeadSpec, BEVFormerConfig, CenterHeadSpec,
                    MMBEVFormerLayerSpec]
_MHA_PROJ = ('query', 'key', 'value', 'out')


class _NameMap:
    """Collects torch key -> flax path pairs, one module kind at a time."""

    def __init__(self):
        self.pairs: Dict[str, FlaxPath] = {}
        # torch key -> heads, for flax arrays that split the features
        # into (heads, head_dim)
        self.heads: Dict[str, int] = {}

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

    def mha(self, t: str, f: FlaxPath, heads: int):
        """flax ``MultiHeadDotProductAttention``: per-head query / key /
        value kernels and biases and out kernel; the out bias is (C,)."""
        for name in _MHA_PROJ:
            self.conv(f'{t}.{name}', f + (name,), bias=True)
            self.heads[f'{t}.{name}.weight'] = heads
            if name != 'out':
                self.heads[f'{t}.{name}.bias'] = heads

    def layer_norm(self, t: str, f: FlaxPath):
        self.pairs[f'{t}.weight'] = ('params',) + f + ('scale',)
        self.pairs[f'{t}.bias'] = ('params',) + f + ('bias',)

    def prefixed(self, t: str, f: FlaxPath, pairs: Mapping[str, FlaxPath]):
        """Another model's pairs under torch prefix ``t`` and flax module
        path ``f``."""
        for tkey, path in pairs.items():
            self.pairs[f'{t}.{tkey}'] = (path[0],) + f + tuple(path[1:])


def resnet_name_map(depth: int, stage_with_dcn: Tuple[bool, ...] = (False,)
                    * 4) -> Dict[str, FlaxPath]:
    """torchvision ResNet key -> flax (collection, *path).

    Flax numbers the blocks flat: ``layer{s}.{j}`` is block
    ``sum(blocks[:s-1]) + j``; within a block conv/bn ``c`` is
    ``Conv_{c-1}`` / ``BatchNorm_{c-1}`` and the downsample pair is
    declared last.  In a ``stage_with_dcn`` stage the 3x3 convs are flax
    ``DeformConv`` modules, numbered apart from the plain convs: the
    kernel, as a conv's, and ``conv_offset`` (kernel and bias).
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
            n_deform = n_plain = 0
            for c in range(n_convs):
                if stage_with_dcn[s] and (block is not Bottleneck or c == 1):
                    d = f + (f'DeformConv_{n_deform}',)
                    m.conv(f'{t}.conv{c + 1}', d)
                    m.conv(f'{t}.conv{c + 1}.conv_offset',
                           d + ('conv_offset',), bias=True)
                    n_deform += 1
                else:
                    m.conv(f'{t}.conv{c + 1}', f + (f'Conv_{n_plain}',))
                    n_plain += 1
                m.bn(f'{t}.bn{c + 1}', f + (f'BatchNorm_{c}',))
            if j == 0 and (s > 0 or block is Bottleneck):
                m.conv(f'{t}.downsample.0', f + (f'Conv_{n_plain}',))
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
    if isinstance(cfg, MTLConfig):
        return mtl_name_map(cfg)
    if isinstance(cfg, BEVFormerConfig):
        return _bevformer_map(cfg).pairs
    if isinstance(cfg, OccHeadSpec):
        m = _NameMap()
        (_occ_head_2d if cfg.kind == '2d' else _occ_head_3d)(m, ())
        return m.pairs
    if isinstance(cfg, CenterHeadSpec):
        return center_head_name_map()
    if isinstance(cfg, MMBEVFormerLayerSpec):
        return mm_bevformer_layer_name_map()
    m = _NameMap()
    if cfg.camera_stream:
        _camera_block(m, cfg)
    if cfg.radar_stream:
        _pillar_block(m, cfg.pillars)
    if cfg.lc_fusion and cfg.radar_stream and cfg.camera_stream:
        if cfg.rc_fusion == 'cross_attention':
            cmf = ('CrossModalFusion_0',)
            m.conv('fuse.att_img', cmf + ('att_img',))
            m.conv('fuse.att_radar', cmf + ('att_radar',))
            m.conv_bn('fuse.fuse', cmf + ('ConvBNReLU_0',))
        else:
            m.conv_bn('fuse', ('ConvBNReLU_0',))
        if cfg.se:
            m.conv('se.conv', ('SEBlock_0', 'Conv_0'), bias=True)
    if cfg.with_head:
        _head(m)
    return m.pairs


def _camera_block(m: _NameMap, cfg: BEVFusionConfig):
    """The camera stream: ResNet, FPNC and LiftSplatShoot (the s2d stem
    keeps the standard stem's ``Conv_0``)."""
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


def _bev_encode_trunk(m: _NameMap, t: str, f: FlaxPath):
    """``models/mtl.py:BevEncodeTrunk``; flax numbers its ConvBNReLUs and
    BasicBlocks flat, in call order."""
    m.conv_bn(f'{t}.stem', f + ('ConvBNReLU_0',))
    for i in range(6):
        t_blk = f'{t}.layer{i // 2 + 1}.{i % 2}'
        blk = f + (f'BasicBlock_{i}',)
        for c in range(2):
            m.conv(f'{t_blk}.conv{c + 1}', blk + (f'Conv_{c}',))
            m.bn(f'{t_blk}.bn{c + 1}', blk + (f'BatchNorm_{c}',))
        if i in (2, 4):                  # the stride-2 blocks' shortcut
            m.conv(f'{t_blk}.downsample.0', blk + ('Conv_2',))
            m.bn(f'{t_blk}.downsample.1', blk + ('BatchNorm_2',))
    m.conv_bn(f'{t}.up1', f + ('ConvBNReLU_1',))
    m.conv_bn(f'{t}.up2', f + ('ConvBNReLU_2',))
    m.conv(f'{t}.out', f + ('Conv_0',), bias=True)


def _occ_head_2d(m: _NameMap, f: FlaxPath, t: str = ''):
    for tk, fk in (('conv', 'Conv_0'), ('fc1', 'Dense_0'),
                   ('fc2', 'Dense_1')):
        m.conv(f'{t}{tk}', f + (fk,), bias=True)


def _occ_head_3d(m: _NameMap, f: FlaxPath, t: str = ''):
    for tk, fk in (('lift', 'Dense_0'), ('conv1', 'Conv_0'),
                   ('conv2', 'Conv_1'), ('cls', 'Dense_1')):
        m.conv(f'{t}{tk}', f + (fk,), bias=True)


def mtl_name_map(cfg: MTLConfig) -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for BEVFusionMTL:
    the fusion trunk under ``fusion``, the task trunks, ``det_head`` and
    ``occ_head``."""
    m = _NameMap()
    fcfg = cfg.fusion
    own_det_head = cfg.enable_det and cfg.trunk_mode != 'none'
    if own_det_head:
        fcfg = dataclasses.replace(fcfg, with_head=False)
    m.prefixed('fusion', ('fusion',), name_map(fcfg))
    if cfg.trunk_mode == 'shared':
        _bev_encode_trunk(m, 'shared_trunk', ('shared_trunk',))
    if own_det_head:
        if cfg.trunk_mode == 'per_task':
            _bev_encode_trunk(m, 'det_trunk', ('det_trunk',))
        for i, name in enumerate(('conv_cls', 'conv_reg', 'conv_dir')):
            m.conv(f'det_head.{name}', ('det_head', f'Conv_{i}'), bias=True)
    if cfg.enable_occ:
        if cfg.trunk_mode == 'per_task':
            _bev_encode_trunk(m, 'occ_trunk', ('occ_trunk',))
        _occ_head_2d(m, ('occ_head',), 'occ_head.')
    return m.pairs


def _head_splits(cfg: ModelConfig) -> Dict[str, int]:
    """torch key -> heads of the flax arrays that split their features
    into (heads, head_dim) (BEVFormer's decoder self-attention)."""
    return (_bevformer_map(cfg).heads if isinstance(cfg, BEVFormerConfig)
            else {})


def bevformer_name_map(cfg: BEVFormerConfig) -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for
    BEVFormerDetector: ``img_backbone``, ``img_neck`` and
    ``pts_bbox_head``; flax's ``nn.Sequential`` numbers its layers
    ``layers_<i>``, as ``torch.nn.Sequential`` does."""
    return _bevformer_map(cfg).pairs


def _bevformer_map(cfg: BEVFormerConfig) -> _NameMap:
    m = _NameMap()
    m.prefixed('img_backbone', ('img_backbone',),
               resnet_name_map(cfg.resnet_depth, cfg.stage_with_dcn))
    n_levels = len(cfg.resnet_out_indices)
    for i in range(n_levels):
        m.conv(f'img_neck.lateral_convs.{i}', ('img_neck', f'Conv_{i}'),
               bias=True)
        m.conv(f'img_neck.fpn_convs.{i}', ('img_neck', f'Conv_{n_levels + i}'),
               bias=True)
    t, f = 'pts_bbox_head', ('pts_bbox_head',)
    for name in ('bev_embedding', 'query_embedding'):
        m.pairs[f'{t}.{name}'] = ('params',) + f + (name,)
    for name in ('row_embed', 'col_embed'):
        m.pairs[f'{t}.positional_encoding.{name}'] = (
            ('params',) + f + ('positional_encoding', name))
    tt, tf = f'{t}.transformer', f + ('transformer',)
    for name in ('cams_embeds', 'level_embeds'):
        m.pairs[f'{tt}.{name}'] = ('params',) + tf + (name,)
    for i in (0, 2):
        m.conv(f'{tt}.can_bus_mlp.{i}', tf + ('can_bus_mlp', f'layers_{i}'),
               bias=True)
    m.conv(f'{tt}.reference_points_fc', tf + ('reference_points_fc',),
           bias=True)
    for i in range(cfg.encoder_layers):
        _encoder_layer(m, f'{tt}.encoder.layers.{i}.',
                       tf + ('encoder', f'layer_{i}'))
    for i in range(cfg.decoder_layers):
        tk, fk = f'{tt}.decoder.layers.{i}.', tf + ('decoder', f'layer_{i}')
        m.mha(f'{tk}self_attn',
              fk + ('self_attn', 'MultiHeadDotProductAttention_0'), NUM_HEADS)
        _deform(m, f'{tk}cross_attn', fk + ('cross_attn',))
        _norms_ffn(m, tk, fk)
    bf = f + ('branches',)
    for lvl in range(cfg.decoder_layers):
        for j in (0, 3, 6):
            m.conv(f'{t}.cls_branches.{lvl}.{j}',
                   bf + (f'cls_branches_{lvl}', f'layers_{j}'), bias=True)
        for j in (1, 4):
            m.layer_norm(f'{t}.cls_branches.{lvl}.{j}',
                         bf + (f'cls_branches_{lvl}', f'layers_{j}'))
        for j in (0, 2, 4):
            m.conv(f'{t}.reg_branches.{lvl}.{j}',
                   bf + (f'reg_branches_{lvl}', f'layers_{j}'), bias=True)
    return m


def _deform(m: _NameMap, t: str, f: FlaxPath, output_proj: bool = True):
    """A deformable attention's projections."""
    names = ('sampling_offsets', 'attention_weights', 'value_proj') \
        + (('output_proj',) if output_proj else ())
    for name in names:
        m.conv(f'{t}.{name}', f + (name,), bias=True)


def _norms_ffn(m: _NameMap, p: str, f: FlaxPath):
    """A BEVFormer layer's three LayerNorms and FFN, torch names after the
    prefix ``p`` ('' or ending in '.')."""
    for j in range(3):
        m.layer_norm(f'{p}norm{j + 1}', f + (f'LayerNorm_{j}',))
    for j in range(2):
        m.conv(f'{p}ffn.fc{j + 1}', f + ('FFN_0', f'Dense_{j}'), bias=True)


def _encoder_layer(m: _NameMap, p: str, f: FlaxPath):
    """A ``BEVFormerLayer`` (and the part of an ``MMBEVFormerLayer`` it
    shares): TSA, SCA, the norms and the FFN."""
    _deform(m, f'{p}tsa', f + ('tsa',))
    _deform(m, f'{p}sca.deformable_attention',
            f + ('sca', 'deformable_attention'), output_proj=False)
    m.conv(f'{p}sca.output_proj', f + ('sca', 'output_proj'), bias=True)
    _norms_ffn(m, p, f)


def mm_bevformer_layer_name_map() -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for a bare
    ``MMBEVFormerLayer``: a ``BEVFormerLayer``'s keys, the two (1,) gates
    and ``lidar_proj``."""
    m = _NameMap()
    _encoder_layer(m, '', ())
    for name in ('fusion_w_cam', 'fusion_w_pts'):
        m.pairs[name] = ('params', name)
    m.conv('lidar_proj', ('lidar_proj',), bias=True)
    return m.pairs


def center_head_name_map() -> Dict[str, FlaxPath]:
    """torch state_dict key -> flax (collection, *path) for a bare
    ``CenterHead``: the shared block is flax's ``ConvBNReLU_0``, each
    branch ``<name>_conv`` (ConvBNReLU) and ``<name>_out`` (1x1 conv)."""
    m = _NameMap()
    m.conv_bn('shared', ('ConvBNReLU_0',))
    for name, _ in (('heatmap', 0),) + REG_BRANCHES:
        m.conv_bn(f'{name}_conv', (f'{name}_conv',))
        m.conv(f'{name}_out', (f'{name}_out',), bias=True)
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
    for i, stride in enumerate(pc.fpn_strides):
        # A fractional stride is a strided conv, flax's Conv_0.
        m.conv_bn(f'second_fpn.deblocks.{i}',
                  ('SECONDFPN_0', f'DeconvBNReLU_{i}'),
                  conv='deconv' if stride >= 1 else 'conv')


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


def _flax_to_torch_layout(v: np.ndarray, path: FlaxPath,
                          heads: Optional[int] = None) -> np.ndarray:
    """``heads``: the array splits its features into (heads, head_dim)."""
    if heads:
        if path[-1] == 'bias':
            return v.reshape(-1)
        if path[-2] == 'out':                     # (heads, head_dim, C)
            return v.reshape(-1, v.shape[-1]).T
        return v.reshape(v.shape[0], -1).T       # (C, heads, head_dim)
    if v.ndim == 4 and _is_deconv(path):
        return v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if v.ndim == 4:
        return v.transpose(3, 2, 0, 1)
    if v.ndim == 5:
        return v.transpose(4, 3, 0, 1, 2)
    return v.T if v.ndim == 2 and path[-1] == 'kernel' else v


def _torch_to_flax_layout(v: np.ndarray, path: FlaxPath,
                          heads: Optional[int] = None) -> np.ndarray:
    if heads:
        if path[-1] == 'bias':
            return v.reshape(heads, -1)
        if path[-2] == 'out':
            return v.T.reshape(heads, -1, v.shape[0])
        return v.T.reshape(v.shape[1], heads, -1)
    if v.ndim == 4 and _is_deconv(path):
        return v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if v.ndim == 4:
        return v.transpose(2, 3, 1, 0)
    if v.ndim == 5:
        return v.transpose(2, 3, 4, 1, 0)
    return v.T if v.ndim == 2 and path[-1] == 'kernel' else v


def flax_to_torch(variables, cfg: ModelConfig,
                  collections=('params', 'batch_stats')
                  ) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` -> torch state_dict (f32)."""
    sd = {}
    heads = _head_splits(cfg)
    for tkey, path in name_map(cfg).items():
        if path[0] not in collections:
            continue
        v = variables
        for k in path:
            v = v[k]
        v = _flax_to_torch_layout(np.asarray(v, np.float32), path,
                                  heads.get(tkey))
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
    heads = _head_splits(cfg)
    for tkey, path in name_map(cfg).items():
        v = state_dict[tkey].detach().cpu().float().numpy()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _torch_to_flax_layout(
            v, path, heads.get(tkey)).copy(order='C')
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
    BatchNorms; DCNv2 kernels He-normal and their offset convs zero (the
    JAX package's ``DeformConv``)."""
    for module in model.modules():
        if isinstance(module, DeformConv):
            w = module.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / w[0].numel()) ** 0.5)
        elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
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
    for module in model.modules():
        if isinstance(module, DeformConv):
            module.conv_offset.weight.zero_()
            module.conv_offset.bias.zero_()
    return model
