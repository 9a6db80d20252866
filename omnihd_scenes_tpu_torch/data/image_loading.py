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
into ``imgs`` on a device: the host entropy decode and the IDCT kernel
(``data/jpeg.py``, ``kernels/jpeg_idct.py``), then the rectify kernel
(``kernels/rectify.py``, on the maps of ``data/undistort.py``), then a
training batch's image augmentations (:data:`CAMERA_RECORD_KEYS`: the
``photometric`` and ``crop_resize_flip`` kernels); on the CPU the
kernels' plain versions, bit-equal to ``cv2.imdecode`` and OpenCV's
chain (the f32 resizes within 1e-5).  :func:`camera_sizes` is the one
rule for the sizes a decode gives, so a dataset can take its depth
targets' size from the JPEG headers (:func:`source_canvas_hw`).

With ``fast_decode`` (the JAX serving decode, :func:`_load_cam_fast`)
the device path decodes each camera at ``1 / k`` of its size (libjpeg's
reduced IDCTs, ``k`` by ``data/jpeg.py:decode_factor`` from its net
scale) and ``rectify`` takes it to the output size in one remap on the
fused map (``data/undistort.py:fused_rectify_map``), or one u8 resize
without distortion; OpenCV is not imported.
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
        return camera_sources(info, scale, front_back_scale, pad_divisor,
                              mean, std, to_rgb, target_hw, fast_decode)
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
# on the host (the entropy decode reads them there) until
# decode_camera_batch.
JPEG_BYTES, JPEG_OFFSETS = 'jpeg_bytes', 'jpeg_offsets'
CAMERA_SOURCE_KEYS = (JPEG_BYTES, JPEG_OFFSETS, 'cam_intrinsics',
                      'cam_distortion', 'cam_scales', 'image_layout',
                      'image_norm')
# A device-decode training sample's image augmentation draws, applied by
# decode_camera_batch after rectify in the JAX dataset's order: the
# photometric jitter's rows (N, len(augmentation.PHOTOMETRIC_FIELDS)) f32,
# then the crop-resize-flip row (len(augmentation.CROP_RESIZE_FLIP_FIELDS),)
# int64 shared by the sample's cameras.  They stay on the host too.
AUG_PHOTOMETRIC, AUG_CROP_RESIZE_FLIP = ('aug_photometric',
                                         'aug_crop_resize_flip')
CAMERA_RECORD_KEYS = (AUG_PHOTOMETRIC, AUG_CROP_RESIZE_FLIP)
HOST_KEYS = CAMERA_SOURCE_KEYS + CAMERA_RECORD_KEYS


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
                   target_hw: Tuple[int, int] = None,
                   fast_decode: bool = False) -> Dict[str, np.ndarray]:
    """One frame's cameras for the device decode: the files' bytes
    (``jpeg_bytes`` u8, the files concatenated; ``jpeg_offsets`` (N + 1,)
    int64), per camera the camera matrix and plumb-bob coefficients of its
    undistortion map (``cam_intrinsics`` (N, 3, 3), ``cam_distortion`` (N,
    5) f64) and its resize factors (``cam_scales`` (N, 3) f64: the u8
    downscale, ``front_back_scale`` for the front and back cameras and 1
    for the others, then ``scale``, then 0; with ``fast_decode`` 1, 1 and
    the net scale, ``scale`` times the u8 downscale), ``image_layout``
    [target_h, target_w, pad_divisor] int64 (0, 0 when ``target_hw`` is
    None), ``image_norm`` [mean, std, to_rgb] f32, and the host path's
    ``lidar2img`` / ``img2lidar_*``, computed by the same f64 operations
    (the scale matrices applied when the host path applies them: with
    ``fast_decode`` one of the net scale)."""
    blobs, ks, dists, scales, l2is = [], [], [], [], []
    for cam_type, cam_info in info['cams'].items():
        lidar2img, _, viewpad = build_lidar2img(cam_info)
        is_fb = cam_type in ('camera_front', 'camera_back')
        blobs.append(np.fromfile(cam_info['data_path'], np.uint8))
        ks.append(np.asarray(viewpad[:3, :3], np.float64))
        dists.append(_plumb_bob(cam_info['cam_distortion']))
        if fast_decode:
            net = scale * (front_back_scale if is_fb else 1.0)
            s = np.eye(4)
            s[0, 0] = s[1, 1] = net
            scales.append((1.0, 1.0, float(net)))
            l2is.append(s @ lidar2img)
            continue
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
        scales.append((u8_scale, float(scale), 0.0))
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


def collate_jpeg(items: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """The JPEG entries of samples (or of a queue's frames) under one new
    leading axis: the bytes concatenated and each item's offsets (any
    shape ``(..., N + 1)``) rebased onto them and stacked, (B, [T,] N +
    1)."""
    bytes_, offsets, base = [], [], 0
    for s in items:
        b = np.asarray(s[JPEG_BYTES])
        bytes_.append(b)
        offsets.append(np.asarray(s[JPEG_OFFSETS], np.int64) + base)
        base += b.size
    return {JPEG_BYTES: np.concatenate(bytes_),
            JPEG_OFFSETS: np.stack(offsets)}


def stack_camera_sources(frames: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Several frames' camera sources (:data:`CAMERA_SOURCE_KEYS`) as one,
    under a new leading axis: a temporal queue's (T, ...)."""
    out = {k: np.stack([f[k] for f in frames]) for k in CAMERA_SOURCE_KEYS
           if k not in (JPEG_BYTES, JPEG_OFFSETS)}
    out.update(collate_jpeg(frames))
    return out


def _host_array(v) -> np.ndarray:
    """A batch entry (NumPy array or CPU tensor, pinned or not) as NumPy."""
    if hasattr(v, 'numpy'):
        return v.numpy()
    return np.asarray(v)


def _device_map(k: np.ndarray, dist: np.ndarray, hw, device, net: float = 0.0,
                factor: int = 1):
    """The undistortion map of one camera on ``device`` (None without
    distortion): on the CPU the (h, w, 2) int32 map; on the card a
    :class:`kernels.rectify.DeviceMap`, made (uploaded and packed) once
    per calibration, size, fast-decode net scale and factor and device
    and kept, with the tables ``rectify`` adds to it.  With a net scale
    (``net`` > 0), the fused map of the fast decode of an ``hw`` image
    (``data/undistort.py:fused_rectify_map``)."""
    import torch

    from omnihd_scenes_tpu_torch.data.undistort import (fused_rectify_map,
                                                        rectify_map)
    from omnihd_scenes_tpu_torch.kernels.rectify import DeviceMap

    fixed = (fused_rectify_map(k, dist, hw, net, factor) if net > 0
             else rectify_map(k, dist, hw))
    if fixed is None:
        return None
    if device.type == 'cpu':
        return torch.from_numpy(fixed)
    key = (np.ascontiguousarray(k).tobytes(), dist.tobytes(), tuple(hw),
           float(net), int(factor), str(device))
    t = _DEVICE_MAPS.get(key)
    if t is None:
        t = DeviceMap(torch.from_numpy(fixed).pin_memory().to(
            device, non_blocking=True))
        _DEVICE_MAPS[key] = t
    return t


def _resized(hw, factor: float):
    """``cv2.resize``'s size ``(int(h * f), int(w * f))``, or ``hw`` at 1."""
    if factor == 1.0:
        return tuple(hw)
    return int(hw[0] * factor), int(hw[1] * factor)


def decode_factors(cam_scales) -> List[int]:
    """Each camera's reduced-decode factor (:func:`camera_sources` rows):
    by its net scale with the fast decode, else 1."""
    from omnihd_scenes_tpu_torch.data.jpeg import decode_factor

    return [decode_factor(float(r[2])) if r[2] > 0 else 1
            for r in np.asarray(cam_scales, np.float64).reshape(-1, 3)]


def _fast_sizes(hw, net: float, factor: int):
    """JAX's fast-decode sizes of an ``hw`` JPEG (``_load_cam_fast``): the
    source size, the reduced decode's size times the factor (1081 rows at
    1/2 count as 1082), and the output size ``int(src * net)``."""
    src = tuple(-(-int(v) // factor) * factor for v in hw)
    return src, (int(src[0] * net), int(src[1] * net))


def camera_sizes(src_hws, cam_scales, layout):
    """The sizes the host path's steps give a frame's (or batch's) cameras
    from their JPEGs' sizes ``src_hws`` [(h, w), ...]: each one's u8 size
    after the front / back downscale and its size after ``scale``
    (``cam_scales`` rows, :func:`camera_sources`; with the fast decode
    both are :func:`_fast_sizes`' output size), and the padded canvas
    (``image_layout``: the target, else every output size's maximum
    rounded up to the divisor) -> (u8_hws, out_hws, (th, tw))."""
    factors = np.asarray(cam_scales, np.float64).reshape(-1, 3)
    u8_hws, out_hws = [], []
    for hw, f, k in zip(src_hws, factors, decode_factors(factors)):
        if f[2] > 0:
            out = _fast_sizes(hw, float(f[2]), k)[1]
            u8_hws.append(out)
            out_hws.append(out)
            continue
        u8 = _resized(hw, float(f[0]))
        u8_hws.append(u8)
        out_hws.append(_resized(u8, float(f[1])))
    th, tw, pad = (int(v) for v in np.asarray(layout).reshape(-1)[:3])
    if th <= 0:
        th = int(np.ceil(max(h for h, _ in out_hws) / pad) * pad)
        tw = int(np.ceil(max(w for _, w in out_hws) / pad) * pad)
    return u8_hws, out_hws, (th, tw)


def _frame_sizes(data: np.ndarray, offsets) -> list:
    """The (h, w) of each JPEG ``data[a:b]`` from its header."""
    from omnihd_scenes_tpu_torch.data.jpeg import jpeg_header

    return [(h.height, h.width) for h in
            (jpeg_header(data[a:b]) for a, b in zip(offsets[:-1],
                                                     offsets[1:]))]


def source_canvas_hw(sources: Dict) -> Tuple[int, int]:
    """The padded (h, w) that decoding one frame's camera sources gives,
    the host path's ``imgs.shape[1:3]``, from the JPEG headers alone (no
    decode): :func:`camera_sizes` on the frame sizes."""
    data = np.asarray(sources[JPEG_BYTES])
    offsets = np.asarray(sources[JPEG_OFFSETS])
    return camera_sizes(_frame_sizes(data, offsets), sources['cam_scales'],
                        sources['image_layout'])[2]


def decoded_sources(batch: Dict, device):
    """Decode a collated batch's JPEGs on ``device`` -> (the planes of
    each image, :class:`kernels.rectify.Planes`, in (sample, [frame,]
    camera) order, and :func:`kernels.rectify.rectify`'s other arguments:
    undistortion maps, u8 sizes, output sizes, target size, mean, std,
    to_rgb).  The batch's camera sources are NumPy arrays or CPU
    tensors; their offsets (..., N + 1) may carry any leading axes."""
    import torch

    from omnihd_scenes_tpu_torch.data.jpeg import decode_jpeg_planes

    device = torch.device(device)
    src = {k: _host_array(batch[k]) for k in CAMERA_SOURCE_KEYS}
    data = src[JPEG_BYTES]
    offsets = src[JPEG_OFFSETS].reshape(-1, src[JPEG_OFFSETS].shape[-1])
    layouts = src['image_layout'].reshape(-1, 3)
    norms = src['image_norm'].reshape(-1, 7)
    layout, norm = layouts[0], norms[0]
    if not (np.all(layouts == layout) and np.all(norms == norm)):
        raise ValueError('decode_camera_batch: samples of one batch must '
                         'share the image layout and normalisation')
    scales = src['cam_scales'].reshape(-1, 3)
    factors = decode_factors(scales)
    planes = decode_jpeg_planes([data[a:b] for row in offsets
                                 for a, b in zip(row[:-1], row[1:])],
                                device, factors=factors)
    k = src['cam_intrinsics'].reshape(-1, 3, 3)
    dist = src['cam_distortion'].reshape(-1, 5)
    hws = [hw for row in offsets for hw in _frame_sizes(data, row)]
    # A fused map is built at the source size JAX's fast decode takes (the
    # frame's size at factor 1).
    maps = [_device_map(k[j], dist[j], _fast_sizes(hw, net, n)[0], device,
                        net, n)
            for j, (hw, net, n) in enumerate(zip(hws, scales[:, 2].tolist(),
                                                 factors))]
    u8_hws, out_hws, target = camera_sizes(hws, scales, layout)
    return planes, (maps, u8_hws, out_hws, target, norm[:3], norm[3:6],
                    bool(norm[6]))


def augment_decoded(imgs, batch: Dict, lead):
    """Decoded images (M, H, W, 3) with the batch's augmentation records
    applied in the JAX dataset's order (``data/dataset.py:_apply_aug``):
    the photometric jitter (``kernels/photometric.py``), then the
    crop-resize-flip (``kernels/crop_resize_flip.py``), each one launch on
    the card (their plain versions on the CPU); ``lead`` is the records'
    leading shape (the batch's, before the camera axis)."""
    if AUG_PHOTOMETRIC in batch:
        from omnihd_scenes_tpu_torch.kernels.photometric import photometric

        rows = _host_array(batch[AUG_PHOTOMETRIC])
        imgs = photometric(imgs, rows.reshape(imgs.shape[0], -1))
    if AUG_CROP_RESIZE_FLIP in batch:
        from omnihd_scenes_tpu_torch.kernels.crop_resize_flip import (
            crop_resize_flip)

        rows = _host_array(batch[AUG_CROP_RESIZE_FLIP]).reshape(
            int(np.prod(lead)), -1)
        per_image = np.repeat(rows, imgs.shape[0] // rows.shape[0], 0)
        imgs = crop_resize_flip(imgs, per_image)
    return imgs


def decode_camera_batch(batch: Dict, device) -> Dict:
    """``batch`` with its camera sources (:data:`CAMERA_SOURCE_KEYS`, as
    :func:`collate_jpeg` and the loaders batch them) and augmentation
    records (:data:`CAMERA_RECORD_KEYS`) replaced by ``imgs`` (B, [T,] N,
    H, W, 3) f32 on ``device``; a batch without sources is returned as it
    is.  The JPEGs are entropy-decoded on the host (all of the batch's in
    one threaded native call), then on a CUDA device one IDCT launch and
    one ``rectify`` launch (planes to the padded f32 images), then, for a
    training batch that carries them, one ``photometric`` and one
    ``crop_resize_flip`` launch (:func:`augment_decoded`); on the CPU the
    kernels' plain versions.  Both equal the host path's OpenCV chain
    (``tests/test_torch_port_camera_decode.py``,
    ``tests/test_torch_port_jpeg_decode.py``,
    ``tests/test_torch_port_camera_train.py``).  The kernels launch on
    the current stream (``data/prefetch.py`` decodes on its side
    stream)."""
    from omnihd_scenes_tpu_torch.kernels.rectify import rectify

    if JPEG_BYTES not in batch:
        return batch
    lead = tuple(batch[JPEG_OFFSETS].shape[:-1])
    planes, args = decoded_sources(batch, device)
    imgs = augment_decoded(rectify(planes, *args), batch, lead)
    out = {k: v for k, v in batch.items() if k not in HOST_KEYS}
    out['imgs'] = imgs.reshape(*lead, -1, *imgs.shape[1:])
    return out
