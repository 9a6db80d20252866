"""The least time one H100 SXM could take for a kernel's work, and the
card's practical peaks measured (counterpart of
``omnihd_scenes_tpu/tools/roofline.py``).

:func:`bound` is the bound that ``chip_smoke.py`` and
``tools/profile_components.py`` set beside each measured time: the
larger of the operations over the card's dense peak for their type and
the bytes the function must move (each input element it needs read once,
each output written once) over the HBM rate, both from NVIDIA's data
sheet.

The CLI measures what the card reaches in practice, so that a share can
also be taken against a measured ceiling:

- bf16 ``torch.matmul`` at 4096^3 and 8192^3, each chained ``--iters``
  times (:func:`chained_time`: every call's input moved by the previous
  call's scalar, so the calls run in order, timed by CUDA events);
- the fit ``t = flops / R + o`` through the two (:func:`fit_peak`): R the
  practical matmul rate, o the fixed cost of an iteration (the scalar's
  reduction and the launches), which inflates small isolated probes;
- cuDNN's bf16 3x3 SAME conv in channels_last at the two production
  shapes the profile leans on: the DepthNet block conv (256 -> 256 at
  6 x 136 x 240) and the FPNC reduce conv (768 -> 256);
- ``torch._int_mm`` (s8 x s8 -> s32) at 4096^3, the int8 tier's ceiling.

These time PyTorch's library calls (cuBLAS, cuDNN); they port no kernel.

    python -m omnihd_scenes_tpu_torch.tools.roofline [--iters 16] \
        [--small] [--device cuda]

prints the card's name and power limit (``nvidia-smi``), then one JSON
line a probe under the JAX tool's names and in its order.  With
``--wait-for LOCKFILE`` it draws every input first and times once no
other process holds LOCKFILE locked (a caller busy on the card).
``--small`` (256 / 512 dots, 2 x 16 x 24 convs) and ``--device cpu`` run
the harness on the host, where the numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import torch

# Dense tensor-core peaks, the f32 rate outside the tensor cores and the
# HBM3 rate of one H100 SXM (NVIDIA's data sheet).
PEAK_OPS = {'int8': 1979e12, 'bf16': 989e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12
TIMED_RUNS = 3


def bound(ops: float, kind: str, nbytes: float) -> tuple:
    """(least ms, 'operations' or 'bytes'): the larger of ``ops`` over the
    dense peak of ``kind`` and ``nbytes`` over the HBM rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3 if ops else 0.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def conv_cost(n: int, c: int, h: int, w: int, co: int, in_bytes: int,
              out_bytes: int) -> tuple:
    """(operations, bytes) of one fused 3x3 conv of an (N, C, H, W) input
    to Co channels: 2 * 9 * C * Co per output pixel; x, the weight and
    the f32 scale and shift read once, the output written once."""
    ops = 2 * 9 * c * co * n * h * w
    nbytes = (n * h * w * c + 9 * c * co) * in_bytes + 2 * co * 4 \
        + n * h * w * co * out_bytes
    return ops, nbytes


def splat_cost(depth_elems: int, feat_elems: int, in_range: int,
               channels: int, out_elems: int, in_bytes: int,
               out_bytes: int) -> tuple:
    """(operations, bytes) of the scatter splat (``ops/bev_pool.py``): a
    multiply and an add per channel for each frustum point that lands in
    the grid (this run's count, in f32); the depth and the features read
    once, the grid written once (the ids come from the camera geometry)."""
    return (2 * in_range * channels,
            (depth_elems + feat_elems) * in_bytes + out_elems * out_bytes)


def chained_time(fn, args, iters: int, device) -> float:
    """Seconds an iteration of ``fn`` chained ``iters`` times: ``fn(carry,
    *args)`` returns a 0-dim tensor that becomes the next call's carry
    (the JAX tool's ``fori_loop`` carry), so each call waits for the one
    before.  One warm-up, then the least of three timed runs (one run
    carries its whole run-to-run noise into the fit): CUDA events around
    the ``iters`` calls on a card, ``time.perf_counter`` on the host."""
    device = torch.device(device)
    cuda = device.type == 'cuda'

    def loop():
        c = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            c = fn(c, *args).float()
        return c

    with torch.inference_mode():
        float(loop())                           # warm-up
        best = float('inf')
        for _ in range(TIMED_RUNS):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                c = loop()
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                c = loop()
                seconds = time.perf_counter() - t0
            if not bool(torch.isfinite(c)):
                raise FloatingPointError(f'the chained carry is {float(c)}')
            best = min(best, seconds)
    return best / iters


def to_bf16(a: np.ndarray, device) -> torch.Tensor:
    """A NumPy draw on ``device`` in bf16, rounded once from f32 as
    ``astype(jnp.bfloat16)`` rounds it (an f64 draw goes through f32
    first, as ml_dtypes' cast does)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device=device, dtype=torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _square_draw(n: int, dtype: str) -> tuple:
    """The two (n, n) operands of the JAX tool's dot probe, drawn from
    ``RandomState(0)`` (f32 here, int8 codes for ``'int8'``); kept, so
    that a run may draw them before it waits for the card."""
    rng = np.random.RandomState(0)
    if dtype == 'int8':
        return tuple(rng.randint(-127, 128, size=(n, n)).astype(np.int8)
                     for _ in range(2))
    return tuple(rng.randn(n, n).astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _conv_draw(batch: int, h: int, w: int, cin: int) -> np.ndarray:
    """The conv probe's (batch, h, w, cin) input, from ``RandomState(0)``
    in f32; kept as :func:`_square_draw` keeps its operands."""
    return np.random.RandomState(0).randn(batch, h, w, cin).astype(
        np.float32)


def probe_dot(n: int, iters: int, dtype: str = 'bfloat16', device='cuda'):
    """{probe, ms, tflops} of an n^3 matmul: bf16 through
    ``torch.matmul``, or ``'int8'`` through ``torch._int_mm`` into s32."""
    if dtype == 'int8':
        a, b = (torch.from_numpy(x).to(device)
                for x in _square_draw(n, dtype))
        # cuBLASLt's int8 GEMM takes B column-major ("TN"); XLA picks its
        # layouts itself, so the ceiling is read in the library's own.
        b = b.t().contiguous().t()

        def fn(c, a, b):
            out = torch._int_mm(a + c.to(torch.int8), b)
            return out.float().mean() * 1e-30
    elif dtype == 'bfloat16':
        a, b = (to_bf16(x, device) for x in _square_draw(n, dtype))

        def fn(c, a, b):
            out = torch.matmul(a + c.to(a.dtype), b)
            return out.float().mean() * 1e-30
    else:
        raise ValueError(f'dtype {dtype!r}: bfloat16 or int8')
    t = chained_time(fn, (a, b), iters, device)
    flops = 2.0 * n * n * n
    return {'probe': f'dot_{n}_{dtype}', 'ms': round(t * 1e3, 3),
            'tflops': round(flops / t / 1e12, 3)}


def probe_conv(cin: int, cout: int, hw, iters: int, batch: int = 6,
               dtype: str = 'bfloat16', device='cuda', seed: int = 0):
    """{probe, ms, tflops} of cuDNN's bf16 3x3 SAME conv, bias-free, in
    channels_last: (batch, cin, h, w) -> cout, seeded weights."""
    if dtype != 'bfloat16':
        raise ValueError(f'dtype {dtype!r}: the conv probe is bf16')
    h, w = hw
    x = to_bf16(_conv_draw(batch, h, w, cin), device).permute(0, 3, 1, 2)
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=False).to(
        device=device, dtype=torch.bfloat16,
        memory_format=torch.channels_last)

    def fn(c, x):
        return conv(x + c.to(x.dtype)).float().mean() * 1e-30

    t = chained_time(fn, (x,), iters, device)
    flops = 2.0 * batch * h * w * 9 * cin * cout
    return {'probe': f'conv3x3_{cin}to{cout}_{h}x{w}_{dtype}',
            'ms': round(t * 1e3, 3), 'tflops': round(flops / t / 1e12, 3)}


def fit_peak(r1, r2, n1, n2):
    """Fit t = flops/R + o from two dot measurements (ms keys)."""
    f1, f2 = 2.0 * n1 ** 3, 2.0 * n2 ** 3
    t1, t2 = r1['ms'] * 1e-3, r2['ms'] * 1e-3
    # t = f/R + o  =>  R = (f2 - f1) / (t2 - t1),  o = t1 - f1/R.  Where
    # the larger dot does not take measurably longer (noise, tiny --small
    # shapes on a host) the fit is flagged, not printed as a huge peak.
    if t2 - t1 <= 0.05 * t1:
        return {'probe': 'fitted', 'practical_peak_tflops': None,
                'per_iter_overhead_ms': None,
                'error': 'non-monotonic timings: '
                         f't({n1})={t1 * 1e3:.3f}ms '
                         f't({n2})={t2 * 1e3:.3f}ms'}
    R = (f2 - f1) / (t2 - t1)
    o = t1 - f1 / R
    return {'probe': 'fitted', 'practical_peak_tflops': round(R / 1e12, 1),
            'per_iter_overhead_ms': round(o * 1e3, 3)}


def wait_for(path: str) -> None:
    """Block until no other process holds an exclusive lock on the file
    ``path`` (``fcntl.flock``): a caller that runs other work on the card
    holds it until the timing may start."""
    import fcntl

    with open(path) as f:
        fcntl.flock(f, fcntl.LOCK_SH)
        fcntl.flock(f, fcntl.LOCK_UN)


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the host's
    thread count for a CPU run."""
    if torch.device(device).type != 'cuda':
        return f'cpu ({torch.get_num_threads()} threads)'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--iters', type=int, default=16)
    p.add_argument('--small', action='store_true',
                   help='tiny shapes (a host run / the harness test)')
    p.add_argument('--device', default='cuda')
    p.add_argument('--wait-for', metavar='LOCKFILE',
                   help='draw every input first, then wait until LOCKFILE '
                   'is not locked before timing')
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('roofline: no CUDA device (--device cpu runs the '
                         'harness on the host)')
    if args.small:
        n1, n2, conv_hw, conv_b = 256, 512, (16, 24), 2
    else:
        n1, n2, conv_hw, conv_b = 4096, 8192, (136, 240), 6
    # Library calls at the card's own precision: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.wait_for:
        for n in (n1, n2):
            _square_draw(n, 'bfloat16')
        for cin in (256, 768):
            _conv_draw(conv_b, *conv_hw, cin)
        _square_draw(n1, 'int8')
        wait_for(args.wait_for)

    print(card_line(device), flush=True)
    r1 = probe_dot(n1, args.iters, device=device)
    print(json.dumps(r1), flush=True)
    r2 = probe_dot(n2, max(args.iters // 2, 2), device=device)
    print(json.dumps(r2), flush=True)
    print(json.dumps(fit_peak(r1, r2, n1, n2)), flush=True)
    for cin in (256, 768):
        print(json.dumps(probe_conv(cin, 256, conv_hw, args.iters,
                                    batch=conv_b, device=device)),
              flush=True)
    print(json.dumps(probe_dot(n1, args.iters, dtype='int8',
                               device=device)), flush=True)


if __name__ == '__main__':
    main()
