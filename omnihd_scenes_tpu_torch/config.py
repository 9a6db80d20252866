"""Model and decode configurations, re-declared without flax.

The JAX dataclasses live in flax modules (``models/lss.py:35``,
``models/detectors.py:29``, ``models/bevfusion.py:69``,
``models/anchor_head.py:121``), so importing them would pull in flax.
These copies keep the same fields, defaults and derived properties;
``tests/test_torch_port_config.py`` holds them equal field by field.

Fields that only steer TPU machinery (``splat_impl``,
``splat_shard_axis``, ``cam_b_windows``, ``remat*``, ``axis_name``) are
kept so a configuration means the same thing in both packages.  The port
has one splat implementation per device, does not rematerialise (it
refuses ``remat=True``; ``remat_parts`` and ``remat_exclude`` then change
nothing) and ignores FOV windows, which by construction change no
output.  Options whose value would change the result and that
the port does not implement yet are rejected by
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
