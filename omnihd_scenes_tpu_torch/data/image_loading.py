"""Multi-view camera loading: undistort, rescale, normalize, pad.

Parity target: ``LoadMultiViewImageFromFiles_newsc``
(reference ``datasets/pipelines/loading.py:320-407``) +
``NormalizeMultiviewImage`` / ``RandomScaleImageMultiViewImage`` /
``PadMultiViewImage`` (``pipelines/transform_3d.py``) and the
``lidar2img`` construction in ``newscenes_dataset.py:get_data_info``:

1. build per-cam ``lidar2img = viewpad @ lidar2cam`` from the info dict;
2. ``cv2.undistort`` each image with its per-camera distortion;
3. halve the 1920x1080 front/back cameras and fold the 0.5 into their
   ``lidar2img``/intrinsics;
4. normalize (mean/std, BGR->RGB), apply the global 0.5 test/train
   scale (again folded into ``lidar2img``), pad to a 32-divisible size.

Per-scene undistortion maps are precomputed with
``cv2.initUndistortRectifyMap`` and cached — the reference calls
``cv2.undistort`` per image, which is the host-side bottleneck
(SURVEY.md "undistortion throughput").

Restated from ``omnihd_scenes_tpu/data/image_loading.py`` so the port
imports nothing of the JAX package: the same OpenCV calls in the same
order, hence the same arrays bit for bit.  OpenCV is imported where it
is used; without it the loaders raise an ``ImportError`` that says the
camera data path needs it.

``load_camera_data(..., decode='device')`` is the card's path, which needs
no OpenCV: it reads each camera's JPEG bytes and returns them with what
the pixels' preparation needs (:data:`CAMERA_SOURCE_KEYS`) and the same
``lidar2img`` / ``img2lidar_*`` as the host path (they do not depend on
pixels); :func:`decode_camera_batch` then turns a collated batch of them
into ``imgs`` on a device: nvJPEG (``data/jpeg.py``) and the rectify
kernel (``kernels/rectify.py``, on the maps of ``data/undistort.py``) on
the card, ``cv2.imdecode`` and the kernel's plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_REMAP_CACHE: Dict[tuple, tuple] = {}
_DEVICE_MAPS: Dict[tuple, object] = {}

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def require_cv2():
    """OpenCV, or an error naming what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError('the camera data path (image decode, undistortion '
                          'and resize) needs OpenCV (the cv2 module), which '
                          'is not installed') from e
    return cv2


def build_lidar2img(cam_info: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lidar2img 4x4, lidar2cam 4x4, viewpad 4x4) from a cam info."""
    lidar2cam_r = np.linalg.inv(cam_info['sensor2lidar_rotation'])
    lidar2cam_t = np.asarray(
        cam_info['sensor2lidar_translation']) @ lidar2cam_r.T
    lidar2cam_rt = np.eye(4)
    lidar2cam_rt[:3, :3] = lidar2cam_r.T
    lidar2cam_rt[3, :3] = -lidar2cam_t
    intrinsic = np.array(cam_info['cam_intrinsic'])
    viewpad = np.eye(4)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    lidar2img = viewpad @ lidar2cam_rt.T
    return lidar2img, lidar2cam_rt.T, viewpad


def _undistort(img: np.ndarray, intrinsic: np.ndarray,
               distortion: np.ndarray, cache_key: tuple) -> np.ndarray:
    cv2 = require_cv2()

    if not np.any(np.asarray(distortion)):
        return img
    key = cache_key + (img.shape[0], img.shape[1])
    maps = _REMAP_CACHE.get(key)
    if maps is None:
        k = np.asarray(intrinsic[:3, :3], np.float64)
        maps = cv2.initUndistortRectifyMap(
            k, np.asarray(distortion, np.float64), None, k,
            (img.shape[1], img.shape[0]), cv2.CV_16SC2)
        _REMAP_CACHE[key] = maps
    return cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR)


def _fused_rectify_map(intrinsic: np.ndarray, distortion: np.ndarray,
                       src_hw: Tuple[int, int], net_scale: float,
                       decode_factor: int, cache_key: tuple):
    """Single remap: output pixel (at final scale) -> reduced-decode px.

    Folds undistortion and the net downscale into ONE
    ``initUndistortRectifyMap`` built at the OUTPUT size: the new
    camera matrix is ``S_net @ K`` so the map's source coordinates are
    full-resolution pixels, which are then divided by the JPEG
    reduced-decode factor to sample the small decoded image directly.
    Replaces {full-res undistort remap, full-res float normalize, one
    or two cv2.resize passes} of the reference pipeline
    (``loading.py:362-374`` + ``transform_3d.py`` scale) with one
    small remap — same linear-interpolation math, composed once.
    """
    cv2 = require_cv2()

    key = cache_key + (src_hw, round(net_scale, 6), decode_factor, 'fast')
    maps = _REMAP_CACHE.get(key)
    if maps is None:
        k = np.asarray(intrinsic[:3, :3], np.float64)
        out_wh = (int(src_hw[1] * net_scale), int(src_hw[0] * net_scale))
        k_new = k.copy()
        k_new[:2] *= net_scale
        m1, m2 = cv2.initUndistortRectifyMap(
            k, np.asarray(distortion, np.float64), None, k_new, out_wh,
            cv2.CV_32FC1)
        if decode_factor != 1:
            m1 = m1 / decode_factor
            m2 = m2 / decode_factor
        maps = cv2.convertMaps(m1, m2, cv2.CV_16SC2)
        _REMAP_CACHE[key] = maps
    return maps


_REDUCED_IMREAD = {2: 'IMREAD_REDUCED_COLOR_2', 4: 'IMREAD_REDUCED_COLOR_4',
                   8: 'IMREAD_REDUCED_COLOR_8'}


def _load_cam_fast(cam_info: Dict, net_scale: float, cache_key: tuple,
                   viewpad: np.ndarray) -> np.ndarray:
    """Serving decode path: reduced-res JPEG decode + one fused remap.

    The JPEG decoder downscales in the DCT domain
    (``IMREAD_REDUCED_COLOR_{2,4,8}``) — for the 1920x1080 cameras at
    net scale 0.5 (sides) / 0.25 (front/back) the decoded image IS the
    output grid when distortion is zero, and otherwise feeds one
    output-sized fused undistort+rescale remap.  uint8 end-to-end;
    normalization happens once on the small image in the caller.
    """
    cv2 = require_cv2()

    factor = 1
    for r in (8, 4, 2):
        if net_scale <= 1.0 / r:
            factor = r
            break
    img = cv2.imread(cam_info['data_path'],
                     getattr(cv2, _REDUCED_IMREAD[factor])
                     if factor != 1 else cv2.IMREAD_COLOR)
    assert img is not None, cam_info['data_path']
    src_hw = (img.shape[0] * factor, img.shape[1] * factor)
    out_wh = (int(src_hw[1] * net_scale), int(src_hw[0] * net_scale))
    distortion = np.asarray(cam_info['cam_distortion'])
    if np.any(distortion):
        maps = _fused_rectify_map(viewpad, distortion, src_hw, net_scale,
                                  factor, cache_key)
        img = cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR)
    elif img.shape[1] != out_wh[0] or img.shape[0] != out_wh[1]:
        img = cv2.resize(img, out_wh)
    return img


def load_camera_data(info: Dict,
                     scale: float = 0.5,
                     front_back_scale: float = 0.5,
                     pad_divisor: int = 32,
                     mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD,
                     to_rgb: bool = True,
                     target_hw: Tuple[int, int] = None,
                     fast_decode: bool = False,
                     decode: str = 'host'):
    """Load all cameras of one frame.

    Returns dict with:
        imgs: (N_cam, H, W, 3) float32 normalized;
        lidar2img: (N_cam, 4, 4) final projection (all scales folded);
        img2lidar_rots / img2lidar_trans: (N_cam, 3, 3) / (N_cam, 3)
            inverse transform for LSS frustum lifting.
    With ``decode='device'``, no ``imgs``: the JPEG bytes and the
    rectify parameters (:func:`camera_sources`) for
    :func:`decode_camera_batch`.
    """
    if decode == 'device':
        if fast_decode:
            raise ValueError(
                'image_fast_decode=True (the reduced-DCT JPEG decode, '
                'IMREAD_REDUCED_COLOR_*) has no nvJPEG counterpart: the '
                'device decode refuses it (ROADMAP queue 1 item 3.10)')
        return camera_sources(info, scale, front_back_scale, pad_divisor,
                              mean, std, to_rgb, target_hw)
    if decode != 'host':
        raise ValueError(f"decode must be 'host' or 'device', got {decode!r}")
    cv2 = require_cv2()

    imgs, l2is = [], []
    for cam_type, cam_info in info['cams'].items():
        lidar2img, _, viewpad = build_lidar2img(cam_info)
        is_fb = cam_type in ('camera_front', 'camera_back')
        if fast_decode:
            net = scale * (front_back_scale if is_fb else 1.0)
            img = _load_cam_fast(cam_info, net,
                                 (info['scene_token'], cam_type), viewpad)
            s = np.eye(4)
            s[0, 0] = s[1, 1] = net
            lidar2img = s @ lidar2img
            img = img.astype(np.float32)
            if to_rgb:
                img = img[..., ::-1]
            img = (img - np.asarray(mean, np.float32)) \
                / np.asarray(std, np.float32)
            imgs.append(img)
            l2is.append(lidar2img)
            continue
        img = cv2.imread(cam_info['data_path'])
        assert img is not None, cam_info['data_path']
        img = _undistort(img, viewpad,
                         np.asarray(cam_info['cam_distortion']),
                         cache_key=(info['scene_token'], cam_type))

        if is_fb and front_back_scale != 1.0:
            img = cv2.resize(img, (int(img.shape[1] * front_back_scale),
                                   int(img.shape[0] * front_back_scale)))
            s = np.eye(4)
            s[0, 0] = s[1, 1] = front_back_scale
            lidar2img = s @ lidar2img

        img = img.astype(np.float32)
        if to_rgb:
            img = img[..., ::-1]
        img = (img - np.asarray(mean, np.float32)) / np.asarray(std,
                                                                np.float32)

        if scale != 1.0:
            img = cv2.resize(img, (int(img.shape[1] * scale),
                                   int(img.shape[0] * scale)))
            s = np.eye(4)
            s[0, 0] = s[1, 1] = scale
            lidar2img = s @ lidar2img

        imgs.append(img)
        l2is.append(lidar2img)

    # Pad to a common divisible size (or an explicit target).
    if target_hw is None:
        max_h = max(i.shape[0] for i in imgs)
        max_w = max(i.shape[1] for i in imgs)
        target_hw = (int(np.ceil(max_h / pad_divisor) * pad_divisor),
                     int(np.ceil(max_w / pad_divisor) * pad_divisor))
    padded = np.zeros((len(imgs), target_hw[0], target_hw[1], 3), np.float32)
    for i, img in enumerate(imgs):
        padded[i, :img.shape[0], :img.shape[1]] = \
            img[:target_hw[0], :target_hw[1]]

    lidar2img = np.asarray(l2is, np.float32)
    img2lidar = np.linalg.inv(np.asarray(l2is, np.float64))
    return {
        'imgs': padded,
        'lidar2img': lidar2img,
        'img2lidar_rots': img2lidar[:, :3, :3].astype(np.float32),
        'img2lidar_trans': img2lidar[:, :3, 3].astype(np.float32),
    }


# ---- the device decode path ----------------------------------------------

# The arrays a ``decode='device'`` sample carries for its pixels; they stay
# on the host (nvJPEG reads host bitstreams) until decode_camera_batch.
JPEG_BYTES, JPEG_OFFSETS = 'jpeg_bytes', 'jpeg_offsets'
CAMERA_SOURCE_KEYS = (JPEG_BYTES, JPEG_OFFSETS, 'cam_intrinsics',
                      'cam_distortion', 'cam_scales', 'image_layout',
                      'image_norm')


def _plumb_bob(distortion) -> np.ndarray:
    """(k1, k2, p1, p2, k3) f64 from a calibration's coefficients."""
    d = np.asarray(distortion, np.float64).reshape(-1)
    if d.size > 5 and np.any(d[5:]):
        raise ValueError(f'distortion {d.tolist()}: only the plumb-bob '
                         'coefficients (k1, k2, p1, p2, k3) are undistorted '
                         'on the device path')
    out = np.zeros(5, np.float64)
    out[:min(d.size, 5)] = d[:5]
    return out


def camera_sources(info: Dict, scale: float = 0.5,
                   front_back_scale: float = 0.5, pad_divisor: int = 32,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD, to_rgb: bool = True,
                   target_hw: Tuple[int, int] = None) -> Dict[str, np.ndarray]:
    """One frame's cameras for the device decode: the files' bytes
    (``jpeg_bytes`` u8, the files concatenated; ``jpeg_offsets`` (N + 1,)
    int64), per camera the camera matrix and plumb-bob coefficients of its
    undistortion map (``cam_intrinsics`` (N, 3, 3), ``cam_distortion`` (N,
    5) f64) and its two resize factors (``cam_scales`` (N, 2) f64: the u8
    downscale, ``front_back_scale`` for the front and back cameras and 1
    for the others, then ``scale``), ``image_layout`` [target_h,
    target_w, pad_divisor] int64 (0, 0 when ``target_hw`` is None),
    ``image_norm`` [mean, std, to_rgb] f32, and the host path's
    ``lidar2img`` / ``img2lidar_*``, computed by the same f64 operations
    (the scale matrices applied when the host path applies them)."""
    blobs, ks, dists, scales, l2is = [], [], [], [], []
    for cam_type, cam_info in info['cams'].items():
        lidar2img, _, viewpad = build_lidar2img(cam_info)
        is_fb = cam_type in ('camera_front', 'camera_back')
        u8_scale = 1.0
        if is_fb and front_back_scale != 1.0:
            u8_scale = float(front_back_scale)
            s = np.eye(4)
            s[0, 0] = s[1, 1] = front_back_scale
            lidar2img = s @ lidar2img
        if scale != 1.0:
            s = np.eye(4)
            s[0, 0] = s[1, 1] = scale
            lidar2img = s @ lidar2img
        blobs.append(np.fromfile(cam_info['data_path'], np.uint8))
        ks.append(np.asarray(viewpad[:3, :3], np.float64))
        dists.append(_plumb_bob(cam_info['cam_distortion']))
        scales.append((u8_scale, float(scale)))
        l2is.append(lidar2img)
    offsets = np.zeros(len(blobs) + 1, np.int64)
    offsets[1:] = np.cumsum([b.size for b in blobs])
    lidar2img = np.asarray(l2is, np.float32)
    img2lidar = np.linalg.inv(np.asarray(l2is, np.float64))
    return {
        JPEG_BYTES: np.concatenate(blobs),
        JPEG_OFFSETS: offsets,
        'cam_intrinsics': np.stack(ks),
        'cam_distortion': np.stack(dists),
        'cam_scales': np.asarray(scales, np.float64),
        'image_layout': np.asarray(
            [*(target_hw if target_hw is not None else (0, 0)),
             pad_divisor], np.int64),
        'image_norm': np.asarray([*mean, *std, float(to_rgb)], np.float32),
        'lidar2img': lidar2img,
        'img2lidar_rots': img2lidar[:, :3, :3].astype(np.float32),
        'img2lidar_trans': img2lidar[:, :3, 3].astype(np.float32),
    }


def collate_jpeg(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """The JPEG entries of samples batched: the bytes concatenated and
    each sample's offsets rebased onto them, (B, N + 1)."""
    bytes_, offsets, base = [], [], 0
    for s in samples:
        b = np.asarray(s[JPEG_BYTES])
        bytes_.append(b)
        offsets.append(np.asarray(s[JPEG_OFFSETS], np.int64) + base)
        base += b.size
    return {JPEG_BYTES: np.concatenate(bytes_),
            JPEG_OFFSETS: np.stack(offsets)}


def _host_array(v) -> np.ndarray:
    """A batch entry (NumPy array or CPU tensor, pinned or not) as NumPy."""
    if hasattr(v, 'numpy'):
        return v.numpy()
    return np.asarray(v)


def _device_map(k: np.ndarray, dist: np.ndarray, hw, device):
    """The undistortion map of one camera on ``device`` (None without
    distortion), uploaded once per calibration and device."""
    import torch

    from omnihd_scenes_tpu_torch.data.undistort import rectify_map

    fixed = rectify_map(k, dist, hw)
    if fixed is None:
        return None
    if device.type == 'cpu':
        return torch.from_numpy(fixed)
    key = (np.ascontiguousarray(k).tobytes(), dist.tobytes(), tuple(hw),
           str(device))
    t = _DEVICE_MAPS.get(key)
    if t is None:
        t = torch.from_numpy(fixed).pin_memory().to(device, non_blocking=True)
        _DEVICE_MAPS[key] = t
    return t


def _resized(hw, factor: float):
    """``cv2.resize``'s size ``(int(h * f), int(w * f))``, or ``hw`` at 1."""
    if factor == 1.0:
        return tuple(hw)
    return int(hw[0] * factor), int(hw[1] * factor)


def decoded_sources(batch: Dict, device):
    """Decode a collated batch's JPEGs on ``device`` -> (the BGR u8 images
    in (sample, camera) order, and :func:`kernels.rectify.rectify`'s other
    arguments: undistortion maps, u8 sizes, output sizes, target size,
    mean, std, to_rgb).  The batch's camera sources are NumPy arrays or
    CPU tensors."""
    import torch

    from omnihd_scenes_tpu_torch.data.jpeg import decode_jpegs

    device = torch.device(device)
    src = {k: _host_array(batch[k]) for k in CAMERA_SOURCE_KEYS}
    data, offsets = src[JPEG_BYTES], src[JPEG_OFFSETS]
    b, n_cam = offsets.shape[0], offsets.shape[1] - 1
    layout, norm = src['image_layout'][0], src['image_norm'][0]
    if not (np.all(src['image_layout'] == layout)
            and np.all(src['image_norm'] == norm)):
        raise ValueError('decode_camera_batch: samples of one batch must '
                         'share the image layout and normalisation')
    images = decode_jpegs([data[offsets[i, c]:offsets[i, c + 1]]
                           for i in range(b) for c in range(n_cam)], device)
    k = src['cam_intrinsics'].reshape(b * n_cam, 3, 3)
    dist = src['cam_distortion'].reshape(b * n_cam, 5)
    factors = src['cam_scales'].reshape(b * n_cam, 2)
    maps, u8_hws, out_hws = [], [], []
    for j, img in enumerate(images):
        hw = tuple(img.shape[:2])
        maps.append(_device_map(k[j], dist[j], hw, device))
        u8_hws.append(_resized(hw, float(factors[j, 0])))
        out_hws.append(_resized(u8_hws[-1], float(factors[j, 1])))
    th, tw, pad = (int(v) for v in layout)
    if th <= 0:
        th = int(np.ceil(max(h for h, _ in out_hws) / pad) * pad)
        tw = int(np.ceil(max(w for _, w in out_hws) / pad) * pad)
    return images, (maps, u8_hws, out_hws, (th, tw), norm[:3], norm[3:6],
                    bool(norm[6]))


def decode_camera_batch(batch: Dict, device) -> Dict:
    """``batch`` with its camera sources (:data:`CAMERA_SOURCE_KEYS`, as
    :func:`collate_jpeg` and the loaders batch them) replaced by ``imgs``
    (B, N, H, W, 3) f32 on ``device``; a batch without them is returned as
    it is.  On a CUDA device: one nvJPEG batched decode and the rectify
    kernel's passes; on the CPU: ``cv2.imdecode`` and the plain passes,
    which equal the host path's OpenCV chain (``tests/
    test_torch_port_camera_decode.py``)."""
    from omnihd_scenes_tpu_torch.kernels.rectify import rectify

    if JPEG_BYTES not in batch:
        return batch
    images, args = decoded_sources(batch, device)
    imgs = rectify(images, *args)
    out = {k: v for k, v in batch.items() if k not in CAMERA_SOURCE_KEYS}
    out['imgs'] = imgs.reshape(len(batch[JPEG_OFFSETS]), -1,
                               *imgs.shape[1:])
    return out
