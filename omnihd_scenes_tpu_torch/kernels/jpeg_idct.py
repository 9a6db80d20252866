"""JPEG inverse DCT on the card: the CUDA kernel's wrapper, its plain
PyTorch version and its launch count.

The second half of the card's JPEG decode (``data/jpeg.py``): the host
entropy-decodes each bitstream to int16 DCT coefficients
(``csrc/host_ops.cpp``), and :func:`jpeg_idct` turns every 8x8 block of
a batch into u8 samples with libjpeg's ``jpeg_idct_islow``
(``jidctint.c``), or, for a component decoded at a reduced size (its
``DCT_scaled_size`` 4, 2 or 1, ``data/jpeg.py:scaled_sizes``), with
``jidctred.c``'s ``jpeg_idct_4x4`` / ``_2x2`` / ``_1x1``, in one launch
of ``csrc/jpeg_idct.cu`` whatever mix of sizes the batch holds.  islow:
dequantise
(``coef * q``), the 1-D islow transform down the columns, ``DESCALE`` by
``CONST_BITS - PASS1_BITS`` (11), along the rows, ``DESCALE`` by
``CONST_BITS + PASS1_BITS + 3`` (18), then ``IDCT_range_limit`` with ``&
RANGE_MASK`` as ``jdmaster.c:prepare_range_limit_table`` lays the table
out.  The result equals what ``cv2.imdecode`` (libjpeg-turbo, islow)
computes before its upsampling, bit for bit.  Sums and products are
32-bit words that wrap; for the coefficients a baseline 8-bit encoder
writes nothing wraps, and libjpeg-turbo's SIMD IDCT works in the same
32-bit lanes.

The reduced transforms are the same integer arithmetic on fewer terms:
4x4 never reads coefficient row or column 4 and descales by one bit
more a pass; 2x2 reads only rows and columns 0, 1, 3, 5 and 7 and
descales by two bits more; 1x1 is ``DESCALE(DC * q, 3)``; each then goes
through the same range limit.  Like ``cv2.imread(...,
IMREAD_REDUCED_COLOR_k)`` (libjpeg-turbo with ``scale_denom = k``), they
compute the whole DCT-domain downscale, bit for bit.

Layout (``comps``, one row per component, in buffer order): the first
block, block rows and block columns; component ``k``'s coefficients are
blocks ``[first, first + rows * cols)`` of the int16 buffer (64 a block,
natural order, row-major on the block grid), and its plane, ``rows * s``
by ``cols * s`` u8 at its scaled size ``s`` (:func:`plane_offsets`),
follows the planes of the components before it in the output, from a
16-byte boundary; at ``s = 8`` everywhere a plane is the byte range its
coefficients sat in.

The kernel walks a table of chunks (:func:`idct_chunks`): each block
row of each component cut into runs of up to :data:`CHUNK_BLOCKS`
consecutive blocks, made here in NumPy and uploaded with the component
rows, so no thread of the card searches or divides to find its block.

The JAX package has no such kernel (``cv2.imread`` runs this on its
host, ``IMREAD_REDUCED_COLOR_{2,4,8}`` with ``image_fast_decode``);
bound: bytes, the coefficients read and the planes written once.
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
# jidctred.c's, besides.
FIX_0_211164243, FIX_0_509795579, FIX_0_601344887 = 1730, 4176, 4926
FIX_0_720959822, FIX_0_850430095, FIX_1_061594337 = 5906, 6967, 8697
FIX_1_272758580, FIX_1_451774981, FIX_2_172734803 = 10426, 11893, 17799
FIX_3_624509785 = 29692
# The DCT scaled sizes a component may take.
SCALED_SIZES = (8, 4, 2, 1)


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


def _descale(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


def _red4(v, shift: int):
    """``jpeg_idct_4x4``'s 1-D transform of eight int32 tensors (``v[4]``
    unread) -> its four outputs, each ``DESCALE``d by ``shift``."""
    tmp0 = v[0] << (CONST_BITS + 1)
    tmp2 = v[2] * FIX_1_847759065 + v[6] * -FIX_0_765366865
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = v[7], v[5], v[3], v[1]
    t0 = (z1 * -FIX_0_211164243 + z2 * FIX_1_451774981
          + z3 * -FIX_2_172734803 + z4 * FIX_1_061594337)
    t2 = (z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887
          + z3 * FIX_0_899976223 + z4 * FIX_2_562915447)
    return [_descale(o, shift) for o in (tmp10 + t2, tmp12 + t0,
                                         tmp12 - t0, tmp10 - t2)]


def _red2(v, shift: int):
    """``jpeg_idct_2x2``'s 1-D transform of eight int32 tensors (only
    ``v[0, 1, 3, 5, 7]`` read) -> its two outputs, ``DESCALE``d by
    ``shift``."""
    tmp10 = v[0] << (CONST_BITS + 2)
    t0 = (v[7] * -FIX_0_720959822 + v[5] * FIX_0_850430095
          + v[3] * -FIX_1_272758580 + v[1] * FIX_3_624509785)
    return [_descale(tmp10 + t0, shift), _descale(tmp10 - t0, shift)]


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """``IDCT_range_limit(cinfo)[x & RANGE_MASK]`` for 8-bit samples: the
    low 10 bits read as a signed value, plus 128, clamped to 0..255."""
    s = ((x & 1023) ^ 512) - 512
    return (s + 128).clamp(0, 255).to(torch.uint8)


def idct_blocks_plain(coefs: torch.Tensor, q: torch.Tensor,
                      size: int = 8) -> torch.Tensor:
    """(n, 64) int16 coefficients (natural order) and a (64,) table ->
    (n, size, size) u8 samples: ``jpeg_idct_islow`` at 8, else
    ``jpeg_idct_{size}x{size}``."""
    x = coefs.reshape(-1, 8, 8).int() * q.reshape(1, 8, 8).int()
    if size == 1:
        return range_limit(_descale(x[:, 0, 0], 3)).view(-1, 1, 1)
    pass1, pass2 = CONST_BITS - PASS1_BITS, CONST_BITS + PASS1_BITS + 3
    if size == 8:
        transform = _islow
    elif size == 4:
        transform, pass1, pass2 = _red4, pass1 + 1, pass2 + 1
    elif size == 2:
        transform, pass1, pass2 = _red2, pass1 + 2, pass2 + 2
    else:
        raise ValueError(f'no {size}x{size} IDCT (sizes {SCALED_SIZES})')
    cols = transform([x[:, k, :] for k in range(8)], pass1)  # result rows
    ws = torch.stack(cols, 1)
    rows = transform([ws[:, :, k] for k in range(8)], pass2)  # its columns
    return range_limit(torch.stack(rows, 2))


def jpeg_idct_plain(coefs: torch.Tensor, quant: torch.Tensor,
                    comps, scaled=None) -> torch.Tensor:
    """Plain version of :func:`jpeg_idct`, on any device."""
    sizes = _scaled(comps, scaled)
    starts = plane_offsets(comps, sizes)[0]
    out = _output(comps, sizes, coefs.device)
    for k, ((first, rows, cols), s) in enumerate(zip(_rows(comps), sizes)):
        span = slice(first * 64, (first + rows * cols) * 64)
        px = idct_blocks_plain(coefs[span].view(-1, 64), quant[k], s)
        out[starts[k]:starts[k] + rows * cols * s * s] = px.view(
            rows, cols, s, s).permute(0, 2, 1, 3).reshape(-1)
    return out


def _rows(comps):
    return [tuple(int(v) for v in r[:3]) for r in np.asarray(comps)]


def _scaled(comps, scaled) -> list:
    """Each component's DCT scaled size: ``scaled``, or 8 for all."""
    n = len(np.asarray(comps))
    if scaled is None:
        return [8] * n
    sizes = [int(v) for v in np.asarray(scaled).reshape(-1)]
    if len(sizes) != n or any(v not in SCALED_SIZES for v in sizes):
        raise ValueError(f'jpeg_idct: one scaled size of {SCALED_SIZES} per '
                         f'component, got {sizes}')
    return sizes


# Each plane of jpeg_idct's output starts on a multiple of this many
# bytes: the kernel stores a pixel row of s bytes as one s-byte word.
PLANE_ALIGN = 16


def plane_offsets(comps, scaled=None):
    """Where each component's plane starts in :func:`jpeg_idct`'s output,
    and the output's length: the planes, ``rows * s`` by ``cols * s`` u8
    at each one's scaled size ``s``, one after the other in component
    order, each from the next multiple of :data:`PLANE_ALIGN` bytes (at
    size 8 every plane is a multiple of 64 bytes: no gap)."""
    table = np.asarray(comps, np.int64)
    sizes = np.asarray(_scaled(comps, scaled), np.int64)
    n = table[:, 1] * table[:, 2] * sizes * sizes
    starts, end = [], 0
    for k in n.tolist():
        end = -(-end // PLANE_ALIGN) * PLANE_ALIGN
        starts.append(end)
        end += k
    return starts, end


def _output(comps, scaled, device) -> torch.Tensor:
    """The output buffer of :func:`plane_offsets`' layout: uninitialised,
    but zeroed where gaps lie between the planes (so that the kernel's and
    the plain version's buffers compare whole)."""
    starts, total = plane_offsets(comps, scaled)
    table = np.asarray(comps, np.int64)
    sizes = np.asarray(_scaled(comps, scaled), np.int64)
    ends = np.asarray(starts) + table[:, 1] * table[:, 2] * sizes * sizes
    gaps = bool(np.any(np.asarray(starts[1:]) != ends[:-1]))
    return (torch.zeros if gaps else torch.empty)(
        (total,), dtype=torch.uint8, device=device)


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


# int32 words a component row of the descriptor: csrc/jpeg_idct.cu's
# kCompWords.
COMP_WORDS = 6


def idct_descriptor(table: np.ndarray, scaled=None):
    """What the kernel reads besides the coefficients and quant rows, as
    one int32 CPU tensor: the component rows ``(n_comp, 6)`` (first
    block, block rows, block columns, scaled size, the plane's start in
    the output as low and high words), then :func:`idct_chunks`.
    Returns it with the chunk table's offset in bytes and its row
    count."""
    starts = np.asarray(plane_offsets(table, scaled)[0], np.int64)
    rows = np.zeros((len(table), COMP_WORDS), np.int32)
    rows[:, :3] = np.asarray(table, np.int64)[:, :3]
    rows[:, 3] = _scaled(table, scaled)
    rows[:, 4] = (starts & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    rows[:, 5] = starts >> 32
    chunks = idct_chunks(table)
    desc = torch.from_numpy(np.concatenate([rows.reshape(-1),
                                            chunks.reshape(-1)]))
    return desc, rows.nbytes, len(chunks)


def jpeg_idct(coefs: torch.Tensor, quant: torch.Tensor,
              comps, scaled=None) -> torch.Tensor:
    """u8 planes of a batch's int16 DCT coefficients (``(total,)``, see
    the module's layout), ``quant`` (n_comp, 64) int32 tables in natural
    order, ``comps`` (n_comp, >= 3) int64 rows (first block, block rows,
    block columns), ``scaled`` each component's DCT scaled size (8, 4, 2
    or 1; None: 8 for all) -> the planes, u8, laid out as
    :func:`plane_offsets` says (``(total,)`` at size 8).  CPU tensors go
    to :func:`jpeg_idct_plain`; CUDA tensors launch the kernel once (on
    the descriptor of :func:`idct_descriptor`, built and uploaded pinned
    on every call) or raise."""
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
    sizes = _scaled(table, scaled)
    dev = coefs.device
    if dev.type == 'cpu':
        return jpeg_idct_plain(coefs, quant, table, sizes)
    if dev.type != 'cuda':
        raise ValueError(f'no jpeg_idct for device {dev}')
    if not (coefs.is_contiguous() and quant.is_contiguous()
            and coefs.data_ptr() % 16 == 0 and quant.data_ptr() % 16 == 0):
        raise ValueError('jpeg_idct: contiguous, 16-byte aligned buffers')
    out = _output(table, sizes, dev)
    desc, chunks_at, n_chunks = idct_descriptor(table, sizes)
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


def jpeg_idct_bytes(coefs: torch.Tensor, comps=None, scaled=None) -> int:
    """Bytes the IDCT must move: the int16 coefficients in, the u8
    planes out (at full size without ``comps``; the quant rows and the
    chunk table, 20 bytes a chunk of up to 32 blocks, are under 0.4 % of
    the coefficients and left out)."""
    out = (int(coefs.numel()) if comps is None
           else plane_offsets(comps, scaled)[1])
    return int(coefs.numel()) * 2 + out


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
