"""Time CTA shapes of the JPEG IDCT kernel against each other on the card.

    python -m omnihd_scenes_tpu_torch.tools.idct_variants [--rounds 9]

Builds ``kernels/csrc/jpeg_idct.cu`` once for each shape of
:data:`VARIANTS` (consumer warps a CTA, the CTAs an SM its registers
must allow, stages in each consumer's ring: the ``JPEG_IDCT_*`` macros),
all ``nvcc`` runs at once, into ``kernels/_build/idct_variants/``.  Each
build runs on the same seeded int16 blocks, laid out as the b4 camera
batch (24 x 1080p 4:2:0, 1,175,040 blocks; 1080 rows pad to 68
MCUs of 16, so 136 luma block rows), and must be bit-equal to
``jpeg_idct_plain``.  The builds are then timed in turn, round after
round in a rotating order, with CUDA events around ``--launches`` back to
back launches.  One line a variant (median, least and most ms a launch
over the rounds, registers, the share of the byte bound) and then one
JSON object are printed, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess

import numpy as np
import torch

from omnihd_scenes_tpu_torch.kernels import jpeg_idct as JI
from omnihd_scenes_tpu_torch.kernels._build import (BUILD_DIR, NVCC_FLAGS,
                                                    nvcc_path, source_path)
from omnihd_scenes_tpu_torch.tools.roofline import HBM_BYTES_PER_S

# name -> (consumer warps, least CTAs an SM, stages a consumer); the
# first is the committed shape.
VARIANTS = {
    'c5m3r3': (5, 3, 3),
    'c4m3r3': (4, 3, 3),
    'c3m4r3': (3, 4, 3),
    'c8m2r3': (8, 2, 3),
    'c5m3r2': (5, 3, 2),
    'c5m3r4': (5, 3, 4),
}
B4_GRIDS = [(136, 240), (68, 120), (68, 120)] * 24


def build_all() -> dict:
    """Each variant's library, built in parallel -> {name: (CDLL,
    registers)}."""
    out_dir = BUILD_DIR / 'idct_variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (consumers, min_ctas, ring) in VARIANTS.items():
        lib = out_dir / f'libjpeg_idct_{name}.so'
        cmd = [nvcc_path(), *NVCC_FLAGS, f'-DJPEG_IDCT_CONSUMERS={consumers}',
               f'-DJPEG_IDCT_MIN_CTAS={min_ctas}', f'-DJPEG_IDCT_RING={ring}',
               '-o', str(lib), str(source_path('jpeg_idct'))]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}:\n{log}')
        regs = re.findall(r'Function properties for \S*jpeg_idct_kernel'
                          r'[\s\S]*?Used (\d+) registers', log)
        built[name] = (ctypes.CDLL(str(lib)), int(regs[0]) if regs else None)
    return built


def b4_case(dev, seed: int):
    """Seeded int16 blocks and 8-bit tables at the b4 batch's layout."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    first = np.cumsum([0] + [r * k for r, k in B4_GRIDS])[:-1]
    table = np.array([[f, r, k] for f, (r, k) in zip(first, B4_GRIDS)])
    n = int(sum(r * k for r, k in B4_GRIDS))
    coefs = torch.randint(-1024, 1024, (n * 64,), generator=gen,
                          device=dev).to(torch.int16)
    quant = torch.randint(1, 256, (len(table), 64), generator=gen,
                          device=dev, dtype=torch.int32)
    return coefs, quant, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--launches', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('idct_variants: needs a CUDA device')
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    built = build_all()
    coefs, quant, table = b4_case(dev, args.seed)
    want = JI.jpeg_idct_plain(coefs, quant, table)
    desc, chunks_at, n_chunks = JI.idct_descriptor(table)
    desc = desc.to(dev)
    total = int(coefs.numel() // 64)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = {name: JI.bind_launch(lib) for name, (lib, _) in built.items()}

    def run(name):
        err = launch[name](coefs.data_ptr(), quant.data_ptr(),
                           desc.data_ptr(), desc.data_ptr() + chunks_at,
                           n_chunks, JI.CHUNK_BLOCKS, total,
                           out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f'{name}: CUDA error {err}')

    for name in VARIANTS:
        out.zero_()
        run(name)
        if not torch.equal(out, want):
            raise SystemExit(f'idct_variants: {name} != jpeg_idct_plain')
    times = {name: [] for name in VARIANTS}
    names = list(VARIANTS)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for r in range(args.rounds + 1):           # round 0 warms up
        for name in names[r % len(names):] + names[:r % len(names)]:
            start.record()
            for _ in range(args.launches):
                run(name)
            end.record()
            end.synchronize()
            if r:
                times[name].append(start.elapsed_time(end) / args.launches)
    bound = JI.jpeg_idct_bytes(coefs) / HBM_BYTES_PER_S * 1e3
    rows = {}
    for name, (consumers, min_ctas, ring) in VARIANTS.items():
        t = times[name]
        rows[name] = {'consumers': consumers, 'min_ctas': min_ctas,
                      'ring': ring, 'registers': built[name][1],
                      'median_ms': statistics.median(t), 'min_ms': min(t),
                      'max_ms': max(t), 'share': bound / statistics.median(t)}
        print(f'[idct variant {name}] {consumers} consumer warps, >= '
              f'{min_ctas} CTAs an SM, {ring} stages a ring, '
              f'{built[name][1]} registers: bit-equal to plain; '
              f'{rows[name]["median_ms"]:.4f} ms a launch (median of '
              f'{len(t)} rounds; {min(t):.4f}-{max(t):.4f}) against '
              f'{bound:.4f} ms (bytes; share {rows[name]["share"]:.3f}) '
              f'({card})')
    print(json.dumps({'idct_variants': rows, 'blocks': total,
                      'chunks': n_chunks, 'bound_ms': bound, 'card': card}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
