"""Model and decode configurations, re-declared without flax.

The JAX dataclasses live in flax modules (``models/lss.py:35``,
``models/detectors.py:29``, ``models/bevfusion.py:69``,
``models/mtl.py:83``, ``models/anchor_head.py:121``,
``models/bevformer/detector.py:33``), so importing them would pull in
flax.
These copies keep the same fields, defaults and derived properties;
``tests/test_torch_port_config.py`` holds them equal field by field.

Fields that only steer TPU machinery (``splat_impl``,
``splat_shard_axis``, ``cam_b_windows``, ``axis_name``) are kept so a
configuration means the same thing in both packages.  The port has one
splat implementation per device and ignores FOV windows, which by
construction change no output.  ``remat``, ``remat_exclude`` and
``remat_parts`` checkpoint the same trunks as JAX
(``torch.utils.checkpoint``; numerically invisible), ``splat_mode``
selects the sampling dual or the scatter splat, and ``stem_s2d``,
``camera_stream`` and ``pillar_impl='dense_fold'`` build what JAX builds.
The one value still refused, an ``rc_fusion`` other than ``'concat'`` and
``'cross_attention'``, is rejected by
:func:`omnihd_scenes_tpu_torch.models.bevfusion.check_supported`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.models.anchors import aligned_anchor_grid


@dataclass(frozen=True)
class LSSConfig:
    final_dim: Tuple[int, int] = (544, 960)    # padded input image H, W
    downsample: int = 4                         # feature stride
    camera_depth_range: Tuple[float, float, float] = (1.0, 60.0, 1.0)
    pc_range: Tuple[float, ...] = (-60, -40, -3.0, 60, 40, 5.0)
    grid: float = 0.5
    num_views: int = 6
    inputC: int = 256
    camC: int = 64
    outC: int = 256
    splat_mode: str = 'sample'
    splat_impl: str = 'auto'
    splat_shard_axis: Optional[str] = None
    # True for cameras viewing mostly along BEV x (front/back).
    cam_solve_x: Tuple[bool, ...] = (True, False, False, True, False, False)
    cam_b_windows: Tuple[Tuple[int, int], ...] = None
    remat_parts: Tuple[str, ...] = ()

    _PARTS = ('depthnet', 'bevencode')

    def __post_init__(self):
        bad = set(self.remat_parts) - set(self._PARTS)
        if bad:
            raise ValueError(
                f'remat_parts {sorted(bad)} not in {self._PARTS}')

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (self.final_dim[0] // self.downsample,
                self.final_dim[1] // self.downsample)

    @property
    def depth_bins(self) -> int:
        d0, d1, dd = self.camera_depth_range
        return int((d1 - d0) / dd)

    @property
    def bev_nx(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) voxel counts."""
        return (int((self.pc_range[3] - self.pc_range[0]) / self.grid),
                int((self.pc_range[4] - self.pc_range[1]) / self.grid),
                int((self.pc_range[5] - self.pc_range[2]) / self.grid))

    def frustum(self) -> np.ndarray:
        """(D, fH, fW, 3) f32 image-plane (u, v, depth) points of the
        scatter splat: fH x fW pixel coordinates spread evenly over the
        padded image, at every depth bin (JAX
        ``models/lss.py:LSSConfig.frustum``)."""
        ogf_h, ogf_w = self.final_dim
        f_h, f_w = self.feat_hw
        d0, d1, dd = self.camera_depth_range
        ds = np.arange(d0, d1, dd, dtype=np.float32)
        xs = np.linspace(0, ogf_w - 1, f_w, dtype=np.float32)
        ys = np.linspace(0, ogf_h - 1, f_h, dtype=np.float32)
        grid = np.zeros((len(ds), f_h, f_w, 3), np.float32)
        grid[..., 0] = xs[None, None, :]
        grid[..., 1] = ys[None, :, None]
        grid[..., 2] = ds[:, None, None]
        return grid


@dataclass(frozen=True)
class PointPillarsConfig:
    """Radar pillar stream; defaults = the 4D-radar PointPillars baseline."""

    point_cloud_range: Tuple[float, ...] = (-60, -40, -3.0, 60, 40, 5.0)
    voxel_size: Tuple[float, ...] = (0.25, 0.25, 8.0)
    max_voxels: int = 30000
    max_points_per_voxel: int = 10
    pillar_impl: str = 'sorted'
    bev_hw: Tuple[int, int] = (320, 480)            # y-bins, x-bins
    pfn_channels: Tuple[int, ...] = (64,)
    with_velocity_snr_center: bool = False
    second_layer_nums: Tuple[int, ...] = (3, 5, 5)
    second_strides: Tuple[int, ...] = (2, 2, 2)
    second_channels: Tuple[int, ...] = (64, 128, 256)
    fpn_strides: Tuple[int, ...] = (1, 2, 4)
    fpn_channels: Tuple[int, ...] = (128, 128, 128)
    num_classes: int = 4
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (-60, -40, 0.9104247242165809, 60, 40, 0.9104247242165809),
        (-60, -40, 1.1421614665993767, 60, 40, 1.1421614665993767),
        (-60, -40, 0.9059764319390522, 60, 40, 0.9059764319390522),
        (-60, -40, 1.5158325603046292, 60, 40, 1.5158325603046292),
    )
    anchor_sizes: Tuple[Tuple[float, ...], ...] = (
        (1.9768212501227105, 4.637021209998035, 1.6647611354273741),
        (0.796163784946599, 0.8183815295280997, 1.6895737765415433),
        (0.912318683145357, 1.9201067650572057, 1.620921669034068),
        (2.6724696700336494, 8.184714524976142, 3.0254503871391982),
    )
    anchor_rotations: Tuple[float, ...] = (0.0, 1.5707963)
    axis_name: Optional[str] = None

    @property
    def head_hw(self) -> Tuple[int, int]:
        s = self.second_strides[0] * self.fpn_strides[0]
        return (self.bev_hw[0] // s, self.bev_hw[1] // s)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_rotations)

    def anchors(self) -> np.ndarray:
        """(H, W, A, 9) anchor grid for the head feature map."""
        return aligned_anchor_grid(self.head_hw, list(self.anchor_ranges),
                                   list(self.anchor_sizes),
                                   self.anchor_rotations)


@dataclass(frozen=True)
class BEVFusionConfig:
    camera_stream: bool = True
    radar_stream: bool = True
    lc_fusion: bool = True
    se: bool = True
    rc_fusion: str = 'concat'
    use_depthnet: bool = True
    remat: bool = False
    remat_exclude: Tuple[str, ...] = ()
    num_views: int = 6
    imc: int = 256                     # camera BEV channels
    lic: int = 384                     # radar BEV channels
    resnet_depth: int = 50
    resnet_out_indices: Tuple[int, ...] = (1, 2, 3)
    frozen_backbone_bn: bool = True
    stem_s2d: bool = False
    with_head: bool = True
    lss: LSSConfig = LSSConfig()
    pillars: PointPillarsConfig = PointPillarsConfig()

    _TRUNKS = ('second', 'secondfpn', 'resnet', 'fpnc', 'lss')

    def __post_init__(self):
        bad = set(self.remat_exclude) - set(self._TRUNKS)
        if bad:
            raise ValueError(
                f'remat_exclude {sorted(bad)} not in {self._TRUNKS}')

    @property
    def head_channels(self) -> int:
        if self.radar_stream:
            return self.lic
        return self.imc


@dataclass(frozen=True)
class MTLConfig:
    """BEVFusion-OCC: the fusion trunk with detection and occupancy heads.

    ``task_weights`` (3dod, occ) is carried as in JAX, which stores it and
    applies it nowhere (the occupancy loss's weight is
    ``make_loss_fn_generic``'s ``occ_weight``).  ``trunk_mode``: 'none'
    (the shipped OCC baseline: the fusion trunk's own head serves
    detection, the occupancy head reads the fused BEV), 'per_task' (one
    BevEncode trunk per task between its crop and its decoder) or 'shared'
    (one BevEncode trunk on the full BEV, then the crops).  The grids are
    ((x0, x1, dx), (y0, y1, dy)); None or equal grids crop nothing.
    """

    fusion: BEVFusionConfig = BEVFusionConfig()
    occ_classes: int = 12
    occ_dz: int = 16
    task_weights: Tuple[float, float] = (1.0, 1.0)   # (3dod, occ)
    enable_det: bool = True
    enable_occ: bool = True
    trunk_mode: str = 'none'
    grid_conf: Optional[Tuple] = None
    det_grid_conf: Optional[Tuple] = None
    occ_grid_conf: Optional[Tuple] = None

    def __post_init__(self):
        if self.trunk_mode not in ('none', 'per_task', 'shared'):
            raise ValueError(f"trunk_mode {self.trunk_mode!r} not in "
                             "('none', 'per_task', 'shared')")

    @property
    def pillars(self) -> PointPillarsConfig:
        """The fusion trunk's pillar configuration (its anchors serve the
        detection head)."""
        return self.fusion.pillars


@dataclass(frozen=True)
class BEVFormerConfig:
    """BEVFormer-T: ResNet + FPN image trunk, the temporal BEV encoder
    (TSA, SCA, FFN) and the DETR decoder with its NMS-free head.

    ``sca_query_cap`` < 1 serves the spatial cross-attention on a static
    per-camera capacity of ``ceil(bev_h * bev_w * sca_query_cap)`` queries
    (the reference's max_len rebatching); 1.0 is the masked dense form.
    ``tsa_impl`` is kept so that configurations load, and changes nothing:
    the port always computes the temporal self-attention as the gather
    (grid_sample) form.  The JAX package's ``'windowed'`` dual is a TPU
    formulation that equals the gather form while its overflow probe reads
    0, so where JAX's probe passes, the port computes what JAX computes.
    ``stage_with_dcn`` puts DCNv2 on the ResNet stages it marks (R101-DCN:
    stages 3-4).
    """

    bev_h: int = 160
    bev_w: int = 240
    num_query: int = 900
    num_classes: int = 4
    embed_dims: int = 256
    encoder_layers: int = 3
    decoder_layers: int = 6
    num_cams: int = 6
    queue_length: int = 3
    pc_range: Tuple[float, ...] = (-60, -40, -3.0, 60, 40, 5.0)
    resnet_depth: int = 50
    resnet_out_indices: Tuple[int, ...] = (3,)
    stage_with_dcn: Tuple[bool, bool, bool, bool] = (False,) * 4
    fpn_outs: int = 1
    img_hw: Tuple[int, int] = (544, 960)
    sca_query_cap: float = 1.0
    tsa_impl: str = 'gather'


class DecodeCfg(NamedTuple):
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_thr: float = 0.2
    max_num: int = 500
    dir_offset: float = 0.7854
    dir_limit_offset: float = 0.0


def serving_config() -> BEVFusionConfig:
    """The flagship serving configuration (``bench.py:main`` defaults):
    dense pillars, sampling view transform, production widths."""
    return BEVFusionConfig(pillars=PointPillarsConfig(pillar_impl='dense'))
