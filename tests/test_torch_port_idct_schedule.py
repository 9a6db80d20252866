"""The IDCT kernel's host schedule on the CPU (``kernels/jpeg_idct.py:
idct_chunks``): the chunk table covers every block of every component
once, in buffer order, and no chunk crosses a block row or a component;
the kernel's pixel-row stores, laid out from the table, start on 8 bytes
and tile each plane once for rows of 8, 16, 40 and 488 bytes; and the
plain IDCT run chunk by chunk, in the table's order and at the kernel's
addresses, equals ``jpeg_idct_plain`` bit for bit on the committed JPEG
fixtures and on an odd-grid layout, and decodes the fixtures equal to
``cv2.imdecode`` (what the JAX package's loader runs,
``omnihd_scenes_tpu/data/image_loading.py:177``).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.data import jpeg as J
from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI
from omnihd_scenes_tpu_torch.kernels.rectify import planes_to_bgr

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / 'torch_port_fixtures'
sys.path.insert(0, str(FIXTURES))
from idct_cases import LAYOUTS, comps as _layout, idct_case  # noqa: E402

FIXTURE_NAMES = ('camera_1080p_420', 'noise_64x96_420', 'noise_64x96_444')
K = JI.CHUNK_BLOCKS


def _fixture_blob(name):
    return np.fromfile(FIXTURES / 'jpeg' / f'{name}.jpg', np.uint8)


@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_chunks_cover_every_block_once_within_a_row(name):
    comps = _layout(LAYOUTS[name])
    raw = JI.idct_chunks(comps)
    assert raw.dtype == np.int32 and raw.shape[1] == 5
    chunks = raw.astype(np.int64)
    first, comp, row, col, count = chunks.T
    total = int((comps[:, 1] * comps[:, 2]).sum())
    # In buffer order, each chunk starting where the last ended: every
    # block once.
    assert first[0] == 0 and np.array_equal(first[1:], (first + count)[:-1])
    assert int(first[-1] + count[-1]) == total
    assert np.all((count >= 1) & (count <= K))
    # Inside one block row of one component.
    start, rows, cols = comps[comp].T
    assert np.all((row >= 0) & (row < rows))
    assert np.all((col >= 0) & (col + count <= cols))
    assert np.array_equal(first, start + row * cols + col)
    assert np.all(col % K == 0)
    # Each row is cut into ceil(cols / K) chunks.
    assert len(chunks) == int((comps[:, 1] * -(-comps[:, 2] // K)).sum())


@pytest.mark.parametrize('cols', [1, 2, 5, 61])
def test_row_stores_start_on_8_bytes_and_tile_each_plane(cols):
    """A plane of ``cols`` blocks a row (rows of 8, 16, 40, 488 bytes; the
    odd ones start a pixel row off 16 bytes every other row): the
    kernel's stores, one 8-byte store a block and pixel row, start on 8
    bytes, each chunk's 8 rows are runs of ``count * 8`` bytes inside the
    plane row, and together they write every byte of the plane once."""
    comps = _layout([(3, 5), (7, cols), (2, 3)])
    k = 1
    start, rows = int(comps[k, 0]), int(comps[k, 1])
    pitch = cols * 8
    plane = np.zeros(rows * 8 * pitch, np.int64)
    odd_16 = set()
    for first, comp, row, col, count in JI.idct_chunks(comps).tolist():
        if comp != k:
            continue
        for r in range(8):
            off = start * 64 + (row * 8 + r) * pitch + col * 8
            assert off % 8 == 0
            odd_16.add(off % 16)
            rel = off - start * 64
            assert (row * 8 + r) * pitch <= rel
            assert rel + count * 8 <= (row * 8 + r + 1) * pitch
            plane[rel:rel + count * 8] += 1
    assert np.all(plane == 1)
    assert odd_16 == ({0} if pitch % 16 == 0 else {0, 8})


def _chunked_plain(coefs, quant, comps):
    """``idct_blocks_plain`` run chunk by chunk in the table's order, each
    chunk's pixel rows written where the kernel writes them."""
    comps = np.asarray(comps, np.int64)
    out = torch.zeros(coefs.shape, dtype=torch.uint8)
    written = np.zeros(coefs.numel(), np.int8)
    for first, comp, row, col, count in JI.idct_chunks(comps).tolist():
        px = JI.idct_blocks_plain(
            coefs[first * 64:(first + count) * 64].view(-1, 64), quant[comp])
        start, _, cols = comps[comp, :3].tolist()
        for r in range(8):
            off = start * 64 + (row * 8 + r) * cols * 8 + col * 8
            out[off:off + count * 8] = px[:, r, :].reshape(-1)
            written[off:off + count * 8] += 1
    assert np.all(written == 1)
    return out


@pytest.mark.parametrize('name', FIXTURE_NAMES)
def test_chunked_plain_decodes_the_fixtures(name):
    """The fixture's coefficients: chunk by chunk equals
    ``jpeg_idct_plain``, and its planes decode equal to
    ``cv2.imdecode``."""
    cv2 = pytest.importorskip('cv2')
    data = _fixture_blob(name)
    c = J.entropy_decode([data])
    got = _chunked_plain(c.coefs, c.quant, c.comps)
    assert torch.equal(got, JI.jpeg_idct_plain(c.coefs, c.quant, c.comps))
    (bgr,) = planes_to_bgr(J.planes_of(got, c))
    np.testing.assert_array_equal(bgr.numpy(),
                                  cv2.imdecode(data, cv2.IMREAD_COLOR))


def test_chunked_plain_on_the_odd_grids():
    """Seeded int16 blocks, extremes included, with 8- and 16-bit tables
    over the odd block grids: chunk by chunk equals ``jpeg_idct_plain``."""
    coefs, quant, comps = idct_case(np.random.RandomState(0), LAYOUTS['odd'])
    assert torch.equal(_chunked_plain(coefs, quant, comps),
                       JI.jpeg_idct_plain(coefs, quant, comps))
