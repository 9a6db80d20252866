"""Block layouts and seeded coefficient blocks for the JPEG IDCT's tests
(``tests/test_torch_port_idct_schedule.py`` on the CPU,
``tests/test_torch_port_gpu.py`` on the card); NumPy and torch only.

A layout is a list of block grids ``(block rows, block columns)``, one a
component in buffer order; :func:`comps` turns it into the ``(first
block, block rows, block columns)`` rows that ``jpeg_idct`` takes.
"""

import numpy as np
import torch

from omnihd_scenes_tpu_torch.kernels.jpeg_idct import CHUNK_BLOCKS as K

LAYOUTS = {
    # Rows of 8, 16, 40 and 488 bytes.
    'odd': [(3, 5), (1, 1), (7, 2), (33, 61)],
    # Block rows of K - 1, K, K + 1, 2K - 1 and 2K + 1 blocks, and three
    # 1x1-block images.
    'chunk_edges': [(2, K), (3, K + 1), (2, 2 * K - 1), (1, 1), (1, 1),
                    (1, 1), (5, K - 1), (1, 2 * K + 1)],
    # The b4 camera batch: 24 x 1080p 4:2:0 (1080 rows pad to 68 MCUs of
    # 16, so 136 luma block rows).
    'b4_1080p_420': [(136, 240), (68, 120), (68, 120)] * 24,
}


def comps(grids) -> np.ndarray:
    """(n, 3) int64 rows (first block, block rows, block columns) of a
    layout whose components tile one buffer in order."""
    first = np.cumsum([0] + [r * k for r, k in grids])[:-1]
    return np.array([[f, r, k] for f, (r, k) in zip(first, grids)],
                    np.int64)


def idct_case(rng, grids, n_tables=4):
    """Seeded int16 blocks over a layout (a quarter in +-1024, 8 at
    +32767 and 8 at -32768 when there are enough, the rest anywhere) and
    one table a component, taken in turn from ``n_tables`` of (8-bit,
    ones, 16-bit, all 65535) -> (coefs, quant, comps) on the CPU."""
    n = sum(r * k for r, k in grids)
    blocks = rng.randint(-32768, 32768, (n, 64)).astype(np.int16)
    blocks[:n // 4] = rng.randint(-1024, 1024, (n // 4, 64))
    blocks[n // 4:n // 4 + 8] = 32767
    blocks[n // 4 + 8:n // 4 + 16] = -32768
    tables = [rng.randint(1, 256, 64), np.ones(64, np.int64),
              rng.randint(1, 65536, 64), np.full(64, 65535)]
    quant = np.stack([tables[i % n_tables] for i in range(len(grids))])
    return (torch.from_numpy(blocks.reshape(-1)),
            torch.from_numpy(quant.astype(np.int32)), comps(grids))
