"""Visualization helpers + CLI: BEV point/box plots and camera-image
box projection (counterpart of ``omnihd_scenes_tpu/tools/visualize.py``;
OpenCV and matplotlib are imported by the functions that draw).

Parity targets: ``core/vis_tools/vis_lidar_radar_img.py:14-212``
(``project_pts_on_img``, ``draw_lidar_bbox3d_on_img``),
``models/utils/visual.py`` BEV dumpers and
``tools/analysis_tools/vis_result_camera+radar.py``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from omnihd_scenes_tpu_torch.devkit.boxes import Box
from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion


def box9_corners(box9: np.ndarray) -> np.ndarray:
    """(9,) [x,y,z_bottom,w,l,h,yaw,vx,vy] -> (3, 8) corners."""
    b = Box([box9[0], box9[1], box9[2] + box9[5] / 2],
            [box9[3], box9[4], box9[5]],
            Quaternion(axis=[0, 0, 1], radians=float(box9[6])))
    return b.corners()


def project_pts_on_img(img: np.ndarray, points: np.ndarray,
                       lidar2img: np.ndarray, max_depth: float = 70.0,
                       radius: int = 2) -> np.ndarray:
    """Color-coded point projection onto one camera image."""
    import cv2
    import matplotlib.pyplot as plt

    pts = np.concatenate([points[:, :3], np.ones((len(points), 1))], 1)
    cam = pts @ lidar2img.T
    keep = cam[:, 2] > 0.5
    cam = cam[keep]
    uv = cam[:, :2] / cam[:, 2:3]
    depth = cam[:, 2]
    h, w = img.shape[:2]
    keep = ((uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    uv, depth = uv[keep], depth[keep]
    out = img.copy()
    cmap = plt.get_cmap('jet')
    for (u, v), d in zip(uv.astype(int), depth):
        color = tuple(int(255 * c) for c in cmap(
            min(d / max_depth, 1.0))[:3])
        cv2.circle(out, (u, v), radius, color, -1)
    return out


_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_boxes3d_on_img(img: np.ndarray, boxes9: np.ndarray,
                        lidar2img: np.ndarray,
                        color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """Wireframe 3D boxes projected onto one camera image."""
    import cv2

    out = img.copy()
    for box9 in boxes9:
        corners = box9_corners(box9).T                          # (8, 3)
        homo = np.concatenate([corners, np.ones((8, 1))], 1)
        cam = homo @ lidar2img.T
        if np.any(cam[:, 2] < 0.3):
            continue
        uv = (cam[:, :2] / cam[:, 2:3]).astype(int)
        for a, b in _EDGES:
            cv2.line(out, tuple(uv[a]), tuple(uv[b]), color, thickness)
    return out


def draw_bev(points: np.ndarray = None, gt_boxes: np.ndarray = None,
             pred_boxes: np.ndarray = None,
             pc_range=(-60, -40, -3, 60, 40, 5), out: str = 'bev.png'):
    """BEV scatter of points with GT (green) / prediction (red) boxes."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 8))
    if points is not None:
        ax.scatter(points[:, 0], points[:, 1], s=0.3, c='gray', alpha=0.5)

    def draw(boxes, color):
        for b in boxes:
            corners = box9_corners(b)[:2, [2, 3, 7, 6, 2]]
            ax.plot(corners[0], corners[1], color=color, linewidth=1.2)

    if gt_boxes is not None:
        draw(gt_boxes, 'green')
    if pred_boxes is not None:
        draw(pred_boxes, 'red')
    ax.set_xlim(pc_range[0], pc_range[3])
    ax.set_ylim(pc_range[1], pc_range[4])
    ax.set_aspect('equal')
    plt.savefig(out, dpi=120, bbox_inches='tight')
    plt.close()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description='Visualize a sample')
    p.add_argument('--ann-file', required=True)
    p.add_argument('--index', type=int, default=0)
    p.add_argument('--out-dir', default='vis_out')
    args = p.parse_args(argv)

    from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset

    ds = NewScenesDetDataset(ann_file=args.ann_file, modality='radar',
                             max_points=40000)
    s = ds[args.index]
    os.makedirs(args.out_dir, exist_ok=True)
    pts = s['points'][s['points_mask']]
    gts = s['gt_boxes'][s['gt_mask']]
    out = draw_bev(pts, gts, out=osp.join(args.out_dir,
                                          f'bev_{args.index}.png'))
    print('saved', out)


if __name__ == '__main__':
    main()
