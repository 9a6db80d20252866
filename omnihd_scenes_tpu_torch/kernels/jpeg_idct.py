"""JPEG inverse DCT on the card: the CUDA kernel's wrapper, its plain
PyTorch version and its launch count.

The second half of the card's JPEG decode (``data/jpeg.py``): the host
entropy-decodes each bitstream to int16 DCT coefficients
(``csrc/host_ops.cpp``), and :func:`jpeg_idct` turns every 8x8 block of
a batch into u8 samples with libjpeg's ``jpeg_idct_islow``
(``jidctint.c``), in one launch of ``csrc/jpeg_idct.cu``: dequantise
(``coef * q``), the 1-D islow transform down the columns, ``DESCALE`` by
``CONST_BITS - PASS1_BITS`` (11), along the rows, ``DESCALE`` by
``CONST_BITS + PASS1_BITS + 3`` (18), then ``IDCT_range_limit`` with ``&
RANGE_MASK`` as ``jdmaster.c:prepare_range_limit_table`` lays the table
out.  The result equals what ``cv2.imdecode`` (libjpeg-turbo, islow)
computes before its upsampling, bit for bit.  Sums and products are
32-bit words that wrap; for the coefficients a baseline 8-bit encoder
writes nothing wraps, and libjpeg-turbo's SIMD IDCT works in the same
32-bit lanes.

Layout (``comps``, one row per component, in buffer order): the first
block, block rows and block columns; component ``k``'s coefficients are
blocks ``[first, first + rows * cols)`` of the int16 buffer (64 a block,
natural order, row-major on the block grid), and its plane, ``rows * 8``
by ``cols * 8`` u8, is the same byte range of the output.

The kernel walks a table of chunks (:func:`idct_chunks`): each block
row of each component cut into runs of up to :data:`CHUNK_BLOCKS`
consecutive blocks, made here in NumPy and uploaded with the component
rows, so no thread of the card searches or divides to find its block.

The JAX package has no such kernel (``cv2.imread`` runs this on its
host); bound: bytes, the coefficients read and the planes written once.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

CONST_BITS, PASS1_BITS = 13, 2
# jidctint.c's FIX(x) at CONST_BITS.
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _islow(v, shift: int):
    """The 1-D islow transform of eight int32 tensors (one frequency
    each), each output ``DESCALE``d by ``shift``."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
           tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return [(o + (1 << (shift - 1))) >> shift for o in out]


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """``IDCT_range_limit(cinfo)[x & RANGE_MASK]`` for 8-bit samples: the
    low 10 bits read as a signed value, plus 128, clamped to 0..255."""
    s = ((x & 1023) ^ 512) - 512
    return (s + 128).clamp(0, 255).to(torch.uint8)


def idct_blocks_plain(coefs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, 64) int16 coefficients (natural order) and a (64,) table ->
    (n, 8, 8) u8 samples."""
    x = coefs.reshape(-1, 8, 8).int() * q.reshape(1, 8, 8).int()
    cols = _islow([x[:, k, :] for k in range(8)],
                  CONST_BITS - PASS1_BITS)             # rows of the result
    ws = torch.stack(cols, 1)
    rows = _islow([ws[:, :, k] for k in range(8)],
                  CONST_BITS + PASS1_BITS + 3)         # its columns
    return range_limit(torch.stack(rows, 2))


def jpeg_idct_plain(coefs: torch.Tensor, quant: torch.Tensor,
                    comps) -> torch.Tensor:
    """Plain version of :func:`jpeg_idct`, on any device."""
    out = torch.empty(coefs.shape, dtype=torch.uint8, device=coefs.device)
    for k, (first, rows, cols) in enumerate(_rows(comps)):
        span = slice(first * 64, (first + rows * cols) * 64)
        px = idct_blocks_plain(coefs[span].view(-1, 64), quant[k])
        out[span] = px.view(rows, cols, 8, 8).permute(0, 2, 1, 3).reshape(-1)
    return out


def _rows(comps):
    return [tuple(int(v) for v in r[:3]) for r in np.asarray(comps)]


# Blocks a chunk: one warp's lanes, one a block.  csrc/jpeg_idct.cu's
# kChunk holds the same number, and its launch refuses any other.
CHUNK_BLOCKS = 32


def idct_chunks(comps) -> np.ndarray:
    """The kernel's work list: ``(n_chunks, 5)`` int32 rows (first block,
    component, block row, first block column, count), each a run of up
    to :data:`CHUNK_BLOCKS` consecutive blocks of one block row of one
    component, in buffer order (``comps`` as :func:`jpeg_idct` takes
    it)."""
    k = CHUNK_BLOCKS
    table = np.asarray(comps, np.int64)[:, :3]
    rows, cols = table[:, 1], table[:, 2]
    per_row = -(-cols // k)
    n_k = rows * per_row
    comp = np.repeat(np.arange(len(table)), n_k)
    j = np.arange(int(n_k.sum())) - np.repeat(np.cumsum(n_k) - n_k, n_k)
    row, col = j // per_row[comp], j % per_row[comp] * k
    count = np.minimum(k, cols[comp] - col)
    first = table[comp, 0] + row * cols[comp] + col
    return np.stack([first, comp, row, col, count], 1).astype(np.int32)


def idct_descriptor(table: np.ndarray):
    """What the kernel reads besides the coefficients and quant rows, as
    one int32 CPU tensor: the component rows ``(n_comp, 4)`` (first
    block, block rows, block columns, 0), then :func:`idct_chunks`.
    Returns it with the chunk table's offset in bytes and its row
    count."""
    rows = np.zeros((len(table), 4), np.int32)
    rows[:, :3] = table[:, :3]
    chunks = idct_chunks(table)
    desc = torch.from_numpy(np.concatenate([rows.reshape(-1),
                                            chunks.reshape(-1)]))
    return desc, rows.nbytes, len(chunks)


def jpeg_idct(coefs: torch.Tensor, quant: torch.Tensor,
              comps) -> torch.Tensor:
    """u8 planes of a batch's int16 DCT coefficients (``(total,)``, see
    the module's layout), ``quant`` (n_comp, 64) int32 tables in natural
    order, ``comps`` (n_comp, >= 3) int64 rows (first block, block rows,
    block columns) -> ``(total,)`` u8.  CPU tensors go to
    :func:`jpeg_idct_plain`; CUDA tensors launch the kernel once (on the
    descriptor of :func:`idct_descriptor`, built and uploaded pinned on
    every call) or raise."""
    table = np.ascontiguousarray(np.asarray(comps, np.int64)[:, :3])
    n = table.shape[0]
    if coefs.dtype != torch.int16 or coefs.dim() != 1:
        raise ValueError(f'jpeg_idct: coefficients must be (total,) int16, '
                         f'got {tuple(coefs.shape)} {coefs.dtype}')
    if (quant.dtype != torch.int32 or tuple(quant.shape) != (n, 64)
            or quant.device != coefs.device):
        raise ValueError('jpeg_idct: quant must be (n_comp, 64) int32 on '
                         'the coefficients\' device')
    ends = table[:, 0] + table[:, 1] * table[:, 2]
    if n == 0 or table[0, 0] != 0 or np.any(table[1:, 0] != ends[:-1]) \
            or ends[-1] * 64 != coefs.numel() or np.any(table[:, 1:] <= 0):
        raise ValueError('jpeg_idct: the components must tile the '
                         'coefficient buffer in order')
    if ends[-1] >= 1 << 31:
        raise ValueError('jpeg_idct: at most 2^31 - 1 blocks a call')
    dev = coefs.device
    if dev.type == 'cpu':
        return jpeg_idct_plain(coefs, quant, table)
    if dev.type != 'cuda':
        raise ValueError(f'no jpeg_idct for device {dev}')
    if not (coefs.is_contiguous() and quant.is_contiguous()
            and coefs.data_ptr() % 16 == 0 and quant.data_ptr() % 16 == 0):
        raise ValueError('jpeg_idct: contiguous, 16-byte aligned buffers')
    out = torch.empty(coefs.shape, dtype=torch.uint8, device=dev)
    desc, chunks_at, n_chunks = idct_descriptor(table)
    desc = desc.pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(coefs.data_ptr(), quant.data_ptr(), desc.data_ptr(),
                        desc.data_ptr() + chunks_at, n_chunks, CHUNK_BLOCKS,
                        int(ends[-1]), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'jpeg_idct kernel launch failed: CUDA error {err}')
    jpeg_idct.launches += 1
    return out


jpeg_idct.launches = 0


def jpeg_idct_bytes(coefs: torch.Tensor) -> int:
    """Bytes the IDCT must move: the int16 coefficients in, the u8
    planes out (the quant rows and the chunk table, 20 bytes a chunk of
    up to 32 blocks, are under 0.4 % of that and left out)."""
    return int(coefs.numel()) * 3


@functools.lru_cache(maxsize=None)
def _kernel():
    """``jpeg_idct_launch`` of ``csrc/jpeg_idct.cu``, with its C
    signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    return bind_launch(load_library('jpeg_idct'))


def bind_launch(lib: ctypes.CDLL):
    """``jpeg_idct_launch`` of a built ``csrc/jpeg_idct.cu``, with its C
    signature."""
    fn = lib.jpeg_idct_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn
