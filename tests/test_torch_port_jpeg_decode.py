"""The port's JPEG decode on the CPU (the host entropy decode of
``csrc/host_ops.cpp``, ``kernels/jpeg_idct.py:jpeg_idct_plain``, then
``kernels/rectify.py``'s plain upsampling and colour step) against
``cv2.imdecode`` (libjpeg-turbo, islow IDCT): equal bit for bit over one
grid of encodings (seeded noise and a crop of the flat camera view;
quality 50 / 75 / 95, and 100 on saturated noise so the range limit
clamps; 4:4:4 / 4:2:2 / 4:2:0; a restart interval; optimised Huffman
tables; odd sizes, so MCU padding and edge replication bite) and on the
committed fixtures.  Also: the entropy decode gives the same
coefficients on 1 and 4 threads; what the decode does not take raises;
the IDCT's plain version against the exact transform; the f32 resize's
emulated fused multiply-add against exact rational arithmetic.
"""

import fractions
import pathlib
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from omnihd_scenes_tpu_torch.data import jpeg as J  # noqa: E402
from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI  # noqa: E402
from omnihd_scenes_tpu_torch.kernels import rectify as R  # noqa: E402

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / 'torch_port_fixtures'
sys.path.insert(0, str(FIXTURES))
import make_jpeg_fixtures  # noqa: E402

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _noise(hw, seed=0, saturated=False):
    rng = np.random.RandomState(seed)
    if saturated:
        return (rng.randint(0, 2, hw + (3,)) * 255).astype(np.uint8)
    return rng.randint(0, 256, hw + (3,)).astype(np.uint8)


def _camera_crop():
    """A 136x248 crop of the fixtures' flat camera view: sky, road, a lane
    mark and box edges."""
    return np.ascontiguousarray(
        make_jpeg_fixtures.camera_image()[470:606, 1060:1308])


def _case(image, sampling, quality=95, extra=()):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling], *extra]
    ok, data = cv2.imencode('.jpg', image, params)
    assert ok
    return data.reshape(-1)


def _grid():
    cases = []
    for sampling in SAMPLING:
        for quality in (50, 75, 95):
            cases.append((f'noise37x53-q{quality}-{sampling}',
                          lambda s=sampling, q=quality: _case(
                              _noise((37, 53)), s, q)))
            cases.append((f'camera-q{quality}-{sampling}',
                          lambda s=sampling, q=quality: _case(
                              _camera_crop(), s, q)))
        cases += [
            (f'saturated-q100-{sampling}', lambda s=sampling: _case(
                _noise((48, 72), 1, saturated=True), s, 100)),
            (f'restart3-{sampling}', lambda s=sampling: _case(
                _noise((45, 67), 2), s, 90,
                (cv2.IMWRITE_JPEG_RST_INTERVAL, 3))),
            (f'optimized-{sampling}', lambda s=sampling: _case(
                _noise((29, 41), 3), s, 85, (cv2.IMWRITE_JPEG_OPTIMIZE, 1))),
            (f'odd9x7-{sampling}', lambda s=sampling: _case(
                _noise((9, 7), 4), s)),
        ]
    cases.append(('one-pixel-444', lambda: _case(_noise((1, 1), 5), '444')))
    return cases


GRID = _grid()


@pytest.mark.parametrize('make', [m for _, m in GRID],
                         ids=[n for n, _ in GRID])
def test_decode_equals_cv2_imdecode(make):
    data = make()
    want = cv2.imdecode(data, cv2.IMREAD_COLOR)
    calls = J.decode_jpeg_planes.calls
    (got,) = J.decode_jpegs([data], 'cpu')
    assert J.decode_jpeg_planes.calls == calls + 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('name', make_jpeg_fixtures.FIXTURES)
def test_decode_equals_the_fixtures(name):
    data = np.fromfile(FIXTURES / 'jpeg' / f'{name}.jpg', np.uint8)
    want = np.load(FIXTURES / 'jpeg' / f'{name}.npz')['bgr']
    (got,) = J.decode_jpegs([data], 'cpu')
    np.testing.assert_array_equal(got.numpy(), want)


def test_entropy_decode_is_the_same_on_any_thread_count():
    """One batch of mixed sizes and samplings: the same coefficients,
    tables and layout on 1 and 4 threads, and the batch decodes as each
    image alone."""
    blobs = [_case(_noise((40 + 3 * i, 50 + 5 * i), i), s, 80 + i)
             for i, s in enumerate(['444', '422', '420'] * 2)]
    one, four = (J.entropy_decode(blobs, threads=t) for t in (1, 4))
    assert torch.equal(one.coefs, four.coefs)
    assert torch.equal(one.quant, four.quant)
    np.testing.assert_array_equal(one.comps, four.comps)
    for blob, img in zip(blobs, J.decode_jpegs(blobs, 'cpu', threads=4)):
        np.testing.assert_array_equal(
            img.numpy(), cv2.imdecode(blob, cv2.IMREAD_COLOR))


def _without_restart_marker(data):
    b = bytes(data)
    i = next(i for i in range(len(b) - 1)
             if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7)
    return np.frombuffer(b[:i] + b[i + 2:], np.uint8)


@pytest.mark.parametrize('make,match', [
    (lambda: cv2.imencode('.jpg', _noise((24, 40)),
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1],
     'progressive'),
    (lambda: cv2.imencode('.jpg', _noise((24, 40))[..., 0])[1],
     'components'),
    (lambda: cv2.imencode('.jpg', _noise((24, 40)), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])[1], 'chroma sampling'),
    (lambda: _case(_noise((64, 96)), '420')[:600], 'truncated'),
    (lambda: _without_restart_marker(_case(
        _noise((64, 96)), '420', 90, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2))),
     'restart marker'),
    (lambda: _case(_noise((8, 4)), '420'), 'narrower'),
], ids=['progressive', 'grayscale', '440', 'truncated', 'restart',
        'narrow-chroma'])
def test_decode_refuses(make, match):
    with pytest.raises(ValueError, match=match):
        J.decode_jpegs([make()], 'cpu')


def test_idct_plain_against_the_exact_transform():
    """The islow IDCT (integer, two rounded passes) within one level of
    the exact 2-D inverse DCT of the same dequantised blocks, before the
    range limit, on blocks an 8-bit encoder can write; the wrapper on CPU
    tensors is the plain version over a two-component layout."""
    rng = np.random.RandomState(0)
    coefs = np.zeros((512, 64), np.int16)
    coefs[:, 0] = rng.randint(-400, 400, 512)
    coefs[:, 1:] = rng.laplace(0, 3, (512, 63)).clip(-100, 100)
    q = rng.randint(1, 4, 64).astype(np.int32)
    got = JI.idct_blocks_plain(torch.from_numpy(coefs), torch.from_numpy(q))
    k = np.arange(8)
    basis = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16) \
        * np.where(k == 0, np.sqrt(0.5), 1.0)[None, :] / 2
    deq = (coefs.astype(np.float64) * q).reshape(-1, 8, 8)
    exact = np.einsum('xu,nuv,yv->nxy', basis, deq, basis) + 128
    inside = (exact > 0.5) & (exact < 254.5)
    assert np.abs(got.numpy().astype(float) - exact)[inside].max() <= 1.0
    assert inside.mean() > 0.5
    layout = np.array([[0, 4, 64], [256, 8, 32]])
    quant = torch.from_numpy(np.stack([q, q[::-1].copy()]))
    flat = torch.from_numpy(coefs).reshape(-1)
    planes = JI.jpeg_idct(flat, quant, layout)
    blocks = planes[:256 * 64].view(4, 8, 64, 8).permute(0, 2, 1, 3)
    assert torch.equal(blocks.reshape(256, 8, 8), JI.idct_blocks_plain(
        flat[:256 * 64].view(256, 64), quant[0]))
    with pytest.raises(ValueError, match='tile'):
        JI.jpeg_idct(flat, quant, layout[::-1].copy())
    with pytest.raises(ValueError, match='int16'):
        JI.jpeg_idct(flat.int(), quant, layout)


def _f32_nearest(x: fractions.Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(fractions.Fraction(float(c)) - x),
                                     int(np.frombuffer(c.tobytes(),
                                                       np.int32)[0]) & 1))


def test_lerp_is_one_fused_multiply_add():
    """``rectify._lerp`` (the plain f32 resize's ``fma(b - a, f, a)``)
    rounds once: against exact rational arithmetic on random values and
    on values whose f64 sum falls on an f32 rounding tie."""
    rng = np.random.RandomState(0)
    a = rng.uniform(-3, 3, 400).astype(np.float32)
    b = rng.uniform(-3, 3, 400).astype(np.float32)
    f = rng.uniform(0, 1, 400).astype(np.float32)
    # A tie: b - a = -(2^23 + 2896) 2^-24 and f = (2^23 - 2895) 2^-47
    # make the exact sum 1 - 2^-25 - 4688 2^-71, just below the midpoint of
    # 1 - 2^-24 and 1; its f64 rounding lands on the midpoint, which rounds
    # (to even) up to 1.
    a[:4] = 1.0
    b[:4] = np.float32((2 ** 23 - 2896) * 2.0 ** -24)
    f[:4] = np.float32((2 ** 23 - 2895) * 2.0 ** -47)
    got = R._lerp(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(f)).numpy()
    for i in range(len(a)):
        d = fractions.Fraction(float(np.float32(b[i] - a[i])))
        want = _f32_nearest(fractions.Fraction(float(a[i]))
                            + d * fractions.Fraction(float(f[i])))
        assert got[i] == want, (i, a[i], b[i], f[i], got[i], want)
    assert got[0] == np.float32(1 - 2.0 ** -24)
