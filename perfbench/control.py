"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set
from, on the card at the cell's own size: for each seed a short window of
the program at the cell's load and its output comparison; for the
control seeds also the control, the reference one precision step below
the configuration's (``control`` in the configuration: ``fp8`` below
bfloat16, ``tf32`` below float32 with TF32 off) put in the program's
place on the same calls and compared the same way.  ``--fault`` plants one of
``FAULTS`` in the program first and reads it in the program's place.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        --control-seeds 4,5,6 --seconds 5

One JSON line per seed and side.  The benchmark's own runs never run it.
"""

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench import harness, lowp, manifest


def control_answers(driver, kind: str):
    with lowp.no_tf32():
        return driver.answers(driver.reference(kind), driver.picks())


def scaled_loss(factor: float):
    """A planted fault: the training loss scaled where it is produced.
    Returns (owner, attribute, replacement)."""
    from omnihd_scenes_tpu_torch.train import builder
    orig = builder.DetectionLosses.__call__

    def altered(self, out, batch):
        total, aux = orig(self, out, batch)
        return total * factor, aux
    return builder.DetectionLosses, '__call__', altered


FAULTS = {'loss_x1.05': lambda: scaled_loss(1.05)}


@contextlib.contextmanager
def planted(name):
    """The program with the fault ``name`` planted (none: as it is)."""
    if name is None:
        yield
        return
    owner, attr, value = FAULTS[name]()
    orig = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def readings(cell, seed: int, seconds: float, device, control: bool,
             fault=None):
    driver = manifest.driver(cell).Driver(cell, seed, device)
    with planted(fault):
        driver.setup()
        harness.measure(driver, device, seconds, 0.0)
    driver.release()
    out = [(fault or 'program', driver.check())]
    if control:
        kind = driver.control
        answers = control_answers(driver, kind)
        with lowp.no_tf32():
            out.append((kind, driver.compare(answers, driver.reference())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--fault', choices=sorted(FAULTS),
                    help='plant this fault in the program')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('perfbench.control: no CUDA device', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    cell = manifest.load_cell(args.workload)
    seeds = [(int(s), False) for s in args.seeds.split(',') if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(',') if s]
    for seed, control in seeds:
        t = time.perf_counter()
        for side, numbers in readings(cell, seed, args.seconds, device,
                                      control, args.fault):
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'side': side, 'numbers': numbers,
                              'seconds': time.perf_counter() - t}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
