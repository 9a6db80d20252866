"""Write the JPEG fixtures of ``tests/torch_port_fixtures/jpeg/`` with
OpenCV, and each file's ``cv2.imdecode`` result beside it.

    python tests/torch_port_fixtures/make_jpeg_fixtures.py [OUT_DIR]

* ``camera_1080p_420.jpg``: a 1080x1920 synthetic camera view (sky, road,
  lane marks and four class-coloured boxes, flat colours so the files
  stay small) at ``cv2.imwrite``'s defaults, quality 95 with 4:2:0
  chroma, as the synthetic generator writes its images;
* ``noise_64x96_420.jpg`` / ``noise_64x96_444.jpg``: one seeded uniform
  noise image at quality 95 with 4:2:0 and with 4:4:4 chroma;
* ``<name>.npz``: key ``bgr``, the (h, w, 3) u8 image ``cv2.imdecode``
  returns for the file (libjpeg-turbo's IDCT and upsampling).

The card's nvJPEG decode is held to these decodes (``chip_smoke.py``
phase 34, ``tests/test_torch_port_gpu.py``); ``tests/
test_torch_port_camera_decode.py`` re-runs this script and checks that it
reproduces the committed files.
"""

import os
import sys

import numpy as np

FIXTURES = ('camera_1080p_420', 'noise_64x96_420', 'noise_64x96_444')
# Boxes of the camera view: (convex polygon vertices, BGR colour).
BOXES = (
    (((300, 620), (620, 600), (640, 860), (310, 880)), (40, 60, 200)),
    (((900, 560), (1080, 560), (1090, 700), (890, 700)), (200, 120, 30)),
    (((1350, 520), (1700, 500), (1760, 900), (1380, 940)), (30, 180, 60)),
    (((1120, 580), (1170, 575), (1175, 690), (1118, 695)), (0, 200, 230)),
)


def camera_image() -> np.ndarray:
    import cv2

    img = np.empty((1080, 1920, 3), np.uint8)
    img[:540] = (235, 206, 135)                       # sky
    img[540:] = (90, 90, 90)                          # road
    for x in range(100, 1920, 300):                   # lane marks
        cv2.fillConvexPoly(img, np.array(
            [(x, 800), (x + 120, 800), (x + 110, 830), (x + 10, 830)],
            np.int32), (255, 255, 255))
    for poly, color in BOXES:
        cv2.fillConvexPoly(img, np.array(poly, np.int32), color)
    return img


def noise_image() -> np.ndarray:
    return np.random.RandomState(0).randint(0, 256, (64, 96, 3)).astype(
        np.uint8)


def write(out_dir: str) -> None:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    q = [cv2.IMWRITE_JPEG_QUALITY, 95]
    files = {
        'camera_1080p_420': (camera_image(), q),
        'noise_64x96_420': (noise_image(), q),
        'noise_64x96_444': (noise_image(), q + [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    }
    for name, (img, params) in files.items():
        path = os.path.join(out_dir, f'{name}.jpg')
        if not cv2.imwrite(path, img, params):
            raise OSError(f'cv2.imwrite failed on {path}')
        bgr = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
        np.savez_compressed(os.path.join(out_dir, f'{name}.npz'), bgr=bgr)


if __name__ == '__main__':
    write(sys.argv[1] if len(sys.argv) > 1 else
          os.path.join(os.path.dirname(os.path.abspath(__file__)), 'jpeg'))
