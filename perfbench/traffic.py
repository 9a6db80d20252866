"""The one generator of every traffic mix: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and draws the requests from the seed.

The draws are those of the port's ``serve/synthetic.py`` as it stood when
the benchmark was defined (``random_request``, ``random_stream_frame``),
with the bulk of the data (images) drawn on the device from a
``torch.Generator`` and copied to the host once, where a served request
comes from; the small draws use NumPy's ``default_rng``.  The camera rig
is a frozen copy of ``utils/rig.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

OMNIHD_CAMERA_YAWS = (0.0, 55.0, -55.0, 180.0, 125.0, -125.0)
# Camera axes (x right, y down, z forward) in ego axes (x forward, y left,
# z up).
_CAM_BASE = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]])


def _yaw_mat(yaw_rad: float) -> np.ndarray:
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _intrinsics(img_hw, focal_frac):
    h, w = img_hw
    return np.array([[focal_frac * w, 0.0, w / 2.0],
                     [0.0, focal_frac * w, h / 2.0],
                     [0.0, 0.0, 1.0]])


def ring_rig_lidar2img(img_hw: Tuple[int, int],
                       yaws_deg: Sequence[float] = OMNIHD_CAMERA_YAWS,
                       focal_frac: float = 0.8, cam_height: float = 1.6,
                       cam_radius: float = 1.5) -> np.ndarray:
    """(num_cam, 4, 4) f32 lidar2img of six pinhole cameras at the
    OmniHD-Scenes headings, 1.5 m out and 1.6 m up, f = 0.8 W."""
    proj = np.eye(4)
    proj[:3, :3] = _intrinsics(img_hw, focal_frac)
    out = []
    for yaw in yaws_deg:
        cam2ego = np.eye(4)
        cam2ego[:3, :3] = _yaw_mat(np.deg2rad(yaw)) @ _CAM_BASE
        cam2ego[:3, 3] = _yaw_mat(np.deg2rad(yaw)) @ np.array(
            [cam_radius, 0.0, cam_height])
        out.append(proj @ np.linalg.inv(cam2ego))
    return np.asarray(out, np.float32)


def ring_rig_img2lidar(img_hw: Tuple[int, int],
                       yaws_deg: Sequence[float] = OMNIHD_CAMERA_YAWS,
                       focal_frac: float = 0.8, cam_height: float = 1.6,
                       cam_radius: float = 1.5):
    """The same rig as (rots (N, 3, 3), trans (N, 3)) f32 with
    ``p_ego = rots @ (u d, v d, d) + trans``."""
    k_inv = np.linalg.inv(_intrinsics(img_hw, focal_frac))
    rots, trans = [], []
    for yaw in yaws_deg:
        rots.append(_yaw_mat(np.deg2rad(yaw)) @ _CAM_BASE @ k_inv)
        trans.append(_yaw_mat(np.deg2rad(yaw)) @ np.array(
            [cam_radius, 0.0, cam_height]))
    return np.asarray(rots, np.float32), np.asarray(trans, np.float32)


def substream(seed: int, name: str) -> np.random.Generator:
    """An independent NumPy generator for one use of ``seed``."""
    key = [int(b) for b in name.encode()]
    return np.random.default_rng(np.random.SeedSequence([seed, *key]))


def torch_seed(seed: int, name: str) -> int:
    return int(substream(seed, name).integers(0, 2 ** 63 - 1))


def _device_normal(shape, gen, device) -> np.ndarray:
    return torch.randn(shape, generator=gen, device=device).cpu().numpy()


def serve_pool(mix: dict, model: dict, seed: int, device):
    """``mix['pool']`` distinct requests of ``mix['batch']`` samples, each
    ``(points (B, P, 8), points_mask (B, P), imgs (B, N, H, W, 3), rots
    (B, N, 3, 3), trans (B, N, 3))`` host arrays: radar points uniform
    inside the range (dims 3-7 too), all valid; N(0, 1) images; the ring
    rig for every sample."""
    b, n_pts = mix['batch'], mix['points']
    x0, y0 = model['pillars']['point_cloud_range'][:2]
    h, w = model['lss']['final_dim']
    n_views = model['num_views']
    rots, trans = ring_rig_img2lidar((h, w))
    rng = substream(seed, 'serve')
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed,
                                                                'images'))
    pool = []
    for _ in range(mix['pool']):
        points = rng.uniform(x0 + 5, -x0 - 5, (b, n_pts, 8)).astype(
            np.float32)
        points[..., 1] = rng.uniform(y0 + 2, -y0 - 2, (b, n_pts))
        points[..., 2] = rng.uniform(-2, 4, (b, n_pts))
        pool.append((points, np.ones((b, n_pts), bool),
                     _device_normal((b, n_views, h, w, 3), gen, device),
                     np.tile(rots[None], (b, 1, 1, 1)),
                     np.tile(trans[None], (b, 1, 1))))
    return pool


class StreamPlan:
    """Four (``mix['streams']``) independent streams served one frame
    each per call.  Call ``c`` gives stream ``s`` the frame ``(c +
    s * scene_frames // streams) % scene_frames`` of its scene (the
    streams' scene starts staggered); ``has_prev`` is false on a scene's
    first frame.  The images of call ``c`` are the pool's ``c %
    pool`` batch (N(0, 1)); the relative CAN bus of (call, stream) is drawn
    as ``random_stream_frame`` draws it (a move of up to 1.5 m, a patch
    angle in radians at ``[-2]``, a turn of up to 3 degrees at ``[-1]``)
    from a table of ``can_bus_table`` calls, cycled; the ring rig's
    lidar2img for every camera."""

    def __init__(self, mix: dict, model: dict, seed: int, device):
        self.streams, self.scene = mix['streams'], mix['scene_frames']
        h, w = model['img_hw']
        n_cams = model['num_cams']
        gen = torch.Generator(device=device).manual_seed(
            torch_seed(seed, 'images'))
        self.images = [_device_normal((self.streams, n_cams, h, w, 3), gen,
                                      device)
                       for _ in range(mix['pool'])]
        rng = substream(seed, 'can_bus')
        n, s = mix['can_bus_table'], self.streams
        can = np.zeros((n, s, 18), np.float32)
        can[..., :2] = rng.uniform(-1.5, 1.5, (n, s, 2))
        can[..., -2] = rng.uniform(0.0, 2 * np.pi, (n, s))
        can[..., -1] = rng.uniform(-3.0, 3.0, (n, s))
        self.can_bus = can
        self.lidar2img = np.tile(ring_rig_lidar2img((h, w))[None],
                                 (s, 1, 1, 1))

    def frame_index(self, call: int, stream: int) -> int:
        return (call + stream * self.scene // self.streams) % self.scene

    def call(self, c: int):
        """(imgs, can_bus, lidar2img, has_prev) of call ``c``, host
        arrays, every stream."""
        has_prev = np.array([self.frame_index(c, s) != 0
                             for s in range(self.streams)])
        return (self.images[c % len(self.images)],
                self.can_bus[c % len(self.can_bus)], self.lidar2img,
                has_prev)

    def replay(self, c: int, stream: int):
        """The calls of ``stream``'s scene up to call ``c``: (call,
        has_prev) from the scene's first frame (or call 0) on."""
        start = max(0, c - self.frame_index(c, stream))
        return [(k, self.frame_index(k, stream) != 0)
                for k in range(start, c + 1)]


def train_pool(mix: dict, model: dict, seed: int, device):
    """``mix['pool']`` distinct training batches of ``mix['batch']``
    samples, drawn as ``random_train_batch`` draws them: radar points
    uniform over +-50 m in all 8 dims, all valid; N(0, 1) images; the
    ring rig; ``mix['gt_boxes']`` GT boxes a sample (all 9 dims uniform
    over +-40, sizes 1-4 m), labels over the classes, all valid; the
    depth targets, a normalised Gaussian (std one bin) around a per-pixel
    depth, 0 (no observation) on a fifth of the pixels."""
    b, n_pts, g = mix['batch'], mix['points'], mix['gt_boxes']
    lss = model['lss']
    h, w = lss['final_dim']
    n_views = model['num_views']
    f_h, f_w = h // lss['downsample'], w // lss['downsample']
    d0, d1, dd = lss['camera_depth_range']
    centres = (d0 + dd * np.arange(int((d1 - d0) / dd))).astype(np.float32)
    rots, trans = ring_rig_img2lidar((h, w))
    rng = substream(seed, 'train')
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed,
                                                                'images'))
    pool = []
    for _ in range(mix['pool']):
        gt_boxes = rng.uniform(-40, 40, (b, g, 9)).astype(np.float32)
        gt_boxes[..., 3:6] = rng.uniform(1, 4, (b, g, 3))
        shape = (b, n_views, f_h, f_w)
        d_min = rng.uniform(d0, d1, shape).astype(np.float32)
        d_min[rng.uniform(size=shape) < 0.2] = 0.0
        gauss = np.exp(-0.5 * ((centres - d_min[..., None]) / dd) ** 2)
        pool.append({
            'points': rng.uniform(-50, 50, (b, n_pts, 8)).astype(np.float32),
            'points_mask': np.ones((b, n_pts), bool),
            'imgs': _device_normal((b, n_views, h, w, 3), gen, device),
            'img2lidar_rots': np.tile(rots[None], (b, 1, 1, 1)),
            'img2lidar_trans': np.tile(trans[None], (b, 1, 1)),
            'gt_boxes': gt_boxes,
            'gt_labels': rng.integers(
                0, model['pillars']['num_classes'], (b, g)).astype(np.int32),
            'gt_mask': np.ones((b, g), bool),
            'depth_gaussian': (gauss / np.maximum(
                gauss.sum(-1, keepdims=True), 1e-12)).astype(np.float32),
            'depth_min': d_min,
        })
    return pool
