"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's GPUs.  It
exits non-zero, printing no result, where there is no CUDA device or
fewer than the cell asks for, where the program cannot be imported, or
where JAX or the JAX package has been loaded once the window has closed.
The last lines on standard error, and the result's ``checks``, give every
number compared with its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every compile cache the program or PyTorch may use, at fixed paths in
# the checkout (the port's own kernels build into its ``kernels/_build``).
CACHE = ROOT / '.perfbench_cache'
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('TORCHINDUCTOR_CACHE_DIR', 'inductor')):
    os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, manifest

    cell = manifest.load_cell(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f'perfbench: {args.workload} needs {cell.chips} CUDA '
              f'device(s); found {found}', file=sys.stderr)
        return 3
    try:
        import omnihd_scenes_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f'perfbench: the program is not here ({exc})', file=sys.stderr)
        return 5
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T0)
    found = harness.forbidden_modules()
    if found:
        print(f'perfbench: modules of JAX or the JAX package were loaded: '
              f'{found}', file=sys.stderr)
        return 4
    line['device'] = {'platform': 'gpu',
                      'kind': torch.cuda.get_device_name(device),
                      'count': cell.chips, **line['device']}
    checks = line.pop('checks')
    line['checks'] = checks                 # the last key of the line
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
