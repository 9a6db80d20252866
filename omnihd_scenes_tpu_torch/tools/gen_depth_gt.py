"""Depth ground truth from LiDAR (counterpart of
``omnihd_scenes_tpu/tools/gen_depth_gt.py``).

Parity target: ``tools/gen_depth_gt_newscenes.py:13-147`` -- per sample
and camera, the LiDAR cloud projected into the image through the
camera's ``lidar2img``; the points in front of it (depth > 0.5) that
land inside the ``--img-h`` x ``--img-w`` image are written as sparse
``[u, v, d]`` float32 rows, the same bytes as the JAX tool's.  Host
NumPy, threads over the samples:

    python -m omnihd_scenes_tpu_torch.tools.gen_depth_gt \\
        <dataroot>/synth_infos_temporal_train.pkl [--workers 4] \\
        [--img-h 1080] [--img-w 1920]

Each file goes where ``data/depth_loading.py:load_gt_depth`` reads it
(:func:`~omnihd_scenes_tpu_torch.data.depth_loading.depth_gt_path`: the
camera path with ``cameras`` -> ``depth_gt``, plus ``.bin``), which is the
JAX tool's path for the OmniHD layout (``.../cameras/<sensor>/...``).  For
a layout without a ``cameras`` directory, such as the synthetic
generator's, the JAX tool writes under ``<scene>/depth_gt/<sensor>/``,
where its own loader does not look; this tool writes beside the JPEG,
where both packages' loaders read.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from omnihd_scenes_tpu_torch.data.depth_loading import depth_gt_path
from omnihd_scenes_tpu_torch.data.image_loading import build_lidar2img
from omnihd_scenes_tpu_torch.data.lidar_loading import load_lidar_points


def depth_points_for_cam(points_xyz: np.ndarray, lidar2img: np.ndarray,
                         img_hw) -> np.ndarray:
    """Project lidar xyz into one camera -> (N, 3) [u, v, depth] f32."""
    homo = np.concatenate(
        [points_xyz, np.ones((len(points_xyz), 1))], axis=1)
    cam = homo @ lidar2img.T
    keep = cam[:, 2] > 0.5
    cam = cam[keep]
    uv = cam[:, :2] / cam[:, 2:3]
    d = cam[:, 2]
    ok = ((uv[:, 0] >= 0) & (uv[:, 0] < img_hw[1])
          & (uv[:, 1] >= 0) & (uv[:, 1] < img_hw[0]))
    return np.concatenate([uv[ok], d[ok, None]],
                          axis=1).astype(np.float32)


def process_info(info, img_hw=(1080, 1920)) -> int:
    """Write one sample's depth files -> the number written."""
    pts = load_lidar_points(info['lidar_path'])[:, :3]
    written = 0
    for cam_info in info['cams'].values():
        lidar2img, _, _ = build_lidar2img(cam_info)
        out_path = depth_gt_path(cam_info['data_path'])
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        depth_points_for_cam(pts, lidar2img, img_hw).tofile(out_path)
        written += 1
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description='Generate lidar depth GT')
    p.add_argument('info_pkl')
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--img-h', type=int, default=1080)
    p.add_argument('--img-w', type=int, default=1920)
    args = p.parse_args(argv)

    with open(args.info_pkl, 'rb') as f:
        infos = pickle.load(f)['infos']
    hw = (args.img_h, args.img_w)
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        total = sum(ex.map(lambda i: process_info(i, hw), infos))
    print(f'wrote {total} depth maps for {len(infos)} samples')
    return total


if __name__ == '__main__':
    main()
