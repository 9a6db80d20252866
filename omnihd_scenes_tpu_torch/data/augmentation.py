"""Training augmentations (host-side NumPy).

Parity targets (reference ``datasets/pipelines/``):
- ``PhotoMetricDistortionMultiViewImage`` (``transform_3d.py``):
  random brightness/contrast/saturation/hue jitter applied identically
  across the six views (BEVFormer train pipeline);
- ``GlobalRotScaleTrans`` (mmdet3d, used by lidar pipelines): rotate /
  scale / translate points + boxes together, velocity-aware;
- ``RandomFlip3D``: horizontal BEV flip of points + boxes (+ the radar
  velocity dims, reference ``core/points/radar_points.py``);
- ``CropResizeFlipImage`` / ``RandomScaleImageMultiViewImage`` image
  scale handling lives in :mod:`omnihd_scenes_tpu_torch.data.image_loading`
  (scales folded into lidar2img).

Restated from ``omnihd_scenes_tpu/data/augmentation.py``, function for
function: host NumPy, so every draw and every array is bit-equal to the
JAX package's on an equal ``RandomState``.  ``crop_resize_flip_images``
reads OpenCV through ``image_loading.require_cv2``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def rgb_to_hsv(img: np.ndarray):
    """Float RGB (0-255 scale) -> (H deg [0,360), S [0,1], V) — the
    cv2.COLOR_RGB2HSV float convention (tested against cv2)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = img.max(axis=-1)
    mn = img.min(axis=-1)
    c = v - mn
    safe_c = np.where(c > 0, c, 1.0)
    s = np.where(v > 0, c / np.where(v > 0, v, 1.0), 0.0)
    h = np.select(
        [c == 0, v == r, v == g],
        [0.0,
         (g - b) / safe_c * 60.0,
         (b - r) / safe_c * 60.0 + 120.0],
        (r - g) / safe_c * 60.0 + 240.0)
    return np.mod(h, 360.0), s, v


def hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray):
    """Inverse of :func:`rgb_to_hsv` (cv2 float convention)."""
    h60 = np.mod(h, 360.0) / 60.0
    i = np.floor(h60).astype(np.int32) % 6
    f = h60 - np.floor(h60)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def photometric_distortion(imgs: np.ndarray,
                           rng: np.random.RandomState,
                           brightness_delta: float = 32.0,
                           contrast_range: Tuple[float, float] = (0.5, 1.5),
                           saturation_range: Tuple[float, float] = (0.5, 1.5),
                           hue_delta: float = 18.0,
                           mean: Sequence[float] = None,
                           std: Sequence[float] = None,
                           per_view: bool = False) -> np.ndarray:
    """Jitter normalized multi-view images (N, H, W, 3).

    Reference-faithful HSV-space pipeline (``transform_3d.py``
    PhotoMetricDistortionMultiViewImage, each step p=0.5): brightness
    delta -> contrast (mode draw: before or after the color ops) ->
    HSV saturation scale -> HSV hue shift (degrees, wrapped) ->
    contrast -> random channel swap.  Our images arrive normalized
    (mean/std), so the jitter denormalizes to the 0-255 pixel space,
    applies the reference ops, and renormalizes.  Deliberate deviation
    kept from round 2 (default): parameters are drawn ONCE PER SAMPLE
    and shared by all views, preserving multi-view photometric
    consistency.  ``per_view=True`` restores the reference's exact
    per-view redraw (each view gets independent parameter draws, the
    same rng consumption order per view).  Hue zero-point differs
    RGB-vs-BGR, which is immaterial under a symmetric random hue shift.
    """
    if per_view:
        return np.stack([
            photometric_distortion(
                imgs[i:i + 1], rng, brightness_delta, contrast_range,
                saturation_range, hue_delta, mean, std, per_view=False)[0]
            for i in range(imgs.shape[0])], axis=0)
    if mean is None or std is None:
        from omnihd_scenes_tpu_torch.data.image_loading import (
            IMAGENET_MEAN, IMAGENET_STD)
        mean = IMAGENET_MEAN if mean is None else mean
        std = IMAGENET_STD if std is None else std
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = imgs.astype(np.float32) * std + mean     # 0-255 pixel space
    if rng.randint(2):
        out = out + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        out = out * rng.uniform(*contrast_range)
    h, s, v = rgb_to_hsv(out)
    if rng.randint(2):
        s = s * rng.uniform(*saturation_range)
    if rng.randint(2):
        h = np.mod(h + rng.uniform(-hue_delta, hue_delta), 360.0)
    out = hsv_to_rgb(h, s, v)
    if mode == 0 and rng.randint(2):
        out = out * rng.uniform(*contrast_range)
    if rng.randint(2):
        out = out[..., rng.permutation(3)]
    return (out - mean) / std


def global_rot_scale_trans(points: np.ndarray,
                           gt_boxes: np.ndarray,
                           rng: np.random.RandomState,
                           rot_range: Tuple[float, float] = (-0.3925, 0.3925),
                           scale_range: Tuple[float, float] = (0.95, 1.05),
                           trans_std: Sequence[float] = (0.0, 0.0, 0.0),
                           vel_dims: Optional[Tuple[int, int]] = None):
    """Joint rotation/scale/translation of points + 9-dim boxes.

    points: (N, D) with xyz in dims 0:3 (+ optional velocity dims);
    gt_boxes: (G, 9) [x, y, z, w, l, h, yaw, vx, vy].
    Returns (points, gt_boxes, rot_angle, scale).
    """
    angle = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_range)
    trans = rng.normal(scale=trans_std, size=3)

    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], np.float32)

    pts = points.copy()
    pts[:, :2] = pts[:, :2] @ rot.T
    pts[:, :3] = pts[:, :3] * scale + trans
    if vel_dims is not None:
        a, b = vel_dims
        pts[:, a:b] = pts[:, a:b] @ rot.T * scale

    boxes = gt_boxes.copy()
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, :3] = boxes[:, :3] * scale + trans
    boxes[:, 3:6] *= scale
    boxes[:, 6] += angle
    boxes[:, 7:9] = boxes[:, 7:9] @ rot.T * scale
    return pts, boxes, angle, scale


def random_flip_3d(points: np.ndarray, gt_boxes: np.ndarray,
                   rng: np.random.RandomState,
                   flip_ratio: float = 0.5,
                   vel_dims: Optional[Tuple[int, int]] = None):
    """Horizontal (y-axis) BEV flip of points + boxes (+ velocities)."""
    flipped = bool(rng.uniform() < flip_ratio)
    if not flipped:
        return points, gt_boxes, False
    pts = points.copy()
    pts[:, 1] = -pts[:, 1]
    if vel_dims is not None:
        pts[:, vel_dims[0] + 1] = -pts[:, vel_dims[0] + 1]
    boxes = gt_boxes.copy()
    boxes[:, 1] = -boxes[:, 1]
    boxes[:, 6] = -boxes[:, 6]
    boxes[:, 8] = -boxes[:, 8]
    return pts, boxes, True


# ---------------------------------------------------------------------------
# Image-space augmentations (reference pipelines/augmentation.py:10-369)
# ---------------------------------------------------------------------------

def sample_crop_resize_flip(rng: np.random.RandomState,
                            aug_conf: Dict,
                            training: bool = True):
    """Draw one (resize, resize_dims, crop, flip) tuple shared by all
    views (reference ``CropResizeFlipImage._sample_augmentation``).

    aug_conf: {'resize': [h0, h1, ...] target heights, 'crop':
    (x0, y0, x1, y1), 'rand_flip': bool}.
    """
    crop = tuple(aug_conf['crop'])
    heights = aug_conf.get('resize') or aug_conf.get('reisze')
    resized_h = heights[rng.randint(len(heights))] if training \
        else heights[0]
    crop_h = crop[3] - crop[1]
    crop_w = crop[2] - crop[0]
    resize = resized_h / crop_h
    resize_dims = (int(resized_h / crop_h * crop_w), int(resized_h))
    flip = bool(training and aug_conf.get('rand_flip')
                and rng.randint(2))
    return resize, resize_dims, crop, flip


def crop_resize_flip_images(imgs: np.ndarray,
                            lidar2img: np.ndarray,
                            resize: float,
                            resize_dims: Tuple[int, int],
                            crop: Tuple[int, int, int, int],
                            flip: bool):
    """Crop + resize + optional horizontal flip of all views, with the
    homography folded into ``lidar2img`` (reference
    ``CropResizeFlipImage``).  Unlike the reference — which leaves the
    flip out of the matrix and compensates inside the network — the
    flip IS folded in here, so projections stay consistent end-to-end.

    imgs: (N, H, W, 3); lidar2img: (N, 4, 4).
    Returns (imgs', lidar2img') with imgs' (N, h', w', 3).
    """
    from omnihd_scenes_tpu_torch.data.image_loading import require_cv2

    cv2 = require_cv2()
    new_w, new_h = resize_dims
    x0, y0, x1, y1 = crop
    # Per-axis scales from the ACTUAL output dims: int() truncation in
    # resize_dims makes the true x-scale differ from the nominal
    # `resize` by up to ~1%, and cv2.resize scales to new_w exactly —
    # using `resize` for x would leave lidar2img up to ~1 px off at
    # the right image edge.
    sx = new_w / (x1 - x0)
    sy = new_h / (y1 - y0)
    ida = np.eye(3, dtype=np.float64)
    ida[0, 0] = sx
    ida[1, 1] = sy
    ida[0, 2] = -x0 * sx
    ida[1, 2] = -y0 * sy
    if flip:
        ida = np.array([[-1, 0, new_w - 1], [0, 1, 0], [0, 0, 1]],
                       np.float64) @ ida
    ida4 = np.eye(4, dtype=np.float64)
    ida4[:2, :2] = ida[:2, :2]
    ida4[:2, 2] = ida[:2, 2]      # translation rides the depth row

    out_imgs = []
    out_l2i = []
    for n in range(imgs.shape[0]):
        img = imgs[n, y0:y1, x0:x1]
        img = cv2.resize(img, (new_w, new_h),
                         interpolation=cv2.INTER_LINEAR)
        if flip:
            img = img[:, ::-1]
        out_imgs.append(np.ascontiguousarray(img))
        out_l2i.append((ida4 @ lidar2img[n].astype(np.float64)
                        ).astype(lidar2img.dtype))
    return np.stack(out_imgs), np.stack(out_l2i)


def global_rot_scale_trans_image(gt_boxes: np.ndarray,
                                 lidar2img: np.ndarray,
                                 rng: np.random.RandomState,
                                 rot_range: Tuple[float, float] = (-22.5,
                                                                   22.5),
                                 scale_ratio_range: Tuple[float, float]
                                 = (0.95, 1.05),
                                 flip_dx_ratio: float = 0.5,
                                 flip_dy_ratio: float = 0.5,
                                 points: Optional[np.ndarray] = None,
                                 vel_dims: Optional[Tuple[int, int]] = None):
    """BEV-space rot/scale/flip for camera models: transform the GT
    (and optionally points) and fold the inverse into ``lidar2img`` so
    the images need no change (reference ``GlobalRotScaleTransImage``:
    rotate_bev_along_z -> scale_xyz -> flip_along_x/y, each
    right-multiplying lidar2img by the inverse; rot_range in degrees).

    gt_boxes: (G, 9); lidar2img: (N, 4, 4).
    Returns (gt_boxes', lidar2img', points', params_dict).
    """
    angle = np.deg2rad(rng.uniform(*rot_range))
    scale = rng.uniform(*scale_ratio_range)
    flip_dx = bool(rng.uniform() < flip_dx_ratio)
    flip_dy = bool(rng.uniform() < flip_dy_ratio)

    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], np.float64)

    boxes = gt_boxes.astype(np.float64).copy()
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, 6] += angle
    boxes[:, 7:9] = boxes[:, 7:9] @ rot.T
    boxes[:, :3] *= scale
    boxes[:, 3:6] *= scale
    boxes[:, 7:9] *= scale
    pts = None if points is None else points.astype(np.float64).copy()
    if pts is not None:
        pts[:, :2] = pts[:, :2] @ rot.T
        pts[:, :3] *= scale
        if vel_dims is not None:
            a, b = vel_dims
            pts[:, a:b] = pts[:, a:b] @ rot.T * scale
    if flip_dx:                                   # x -> -x ('vertical')
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -boxes[:, 6] + np.pi
        boxes[:, 7] = -boxes[:, 7]
        if pts is not None:
            pts[:, 0] = -pts[:, 0]
            if vel_dims is not None:
                pts[:, vel_dims[0]] = -pts[:, vel_dims[0]]
    if flip_dy:                                   # y -> -y ('horizontal')
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        boxes[:, 8] = -boxes[:, 8]
        if pts is not None:
            pts[:, 1] = -pts[:, 1]
            if vel_dims is not None:
                pts[:, vel_dims[0] + 1] = -pts[:, vel_dims[0] + 1]

    tf = np.eye(4, dtype=np.float64)
    tf[:2, :2] = rot
    tf[:3, :3] = tf[:3, :3] * scale
    if flip_dx:
        tf = np.diag([-1.0, 1, 1, 1]) @ tf
    if flip_dy:
        tf = np.diag([1.0, -1, 1, 1]) @ tf
    tf_inv = np.linalg.inv(tf)
    new_l2i = np.stack([
        (lidar2img[n].astype(np.float64) @ tf_inv).astype(lidar2img.dtype)
        for n in range(lidar2img.shape[0])])
    params = {'rot': float(angle), 'scale': float(scale),
              'flip_dx': flip_dx, 'flip_dy': flip_dy}
    return (boxes.astype(gt_boxes.dtype), new_l2i,
            None if pts is None else pts.astype(points.dtype), params)
