"""One rank of ``tools.train`` under torchrun, for the data-parallel CLI
test: it records every file and directory the rank creates under the work
dir (``open`` for writing, ``os.makedirs``, ``torch.save``), then saves that list and the rank's final parameters beside it:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_port_fixtures/dp_train_rank.py OUT CONFIG \\
        --work-dir WORK [train arguments]

writes ``OUT/rank<r>.pt`` = {'writes': [...], 'state': state_dict}.
JAX-free.
"""

import builtins
import os
import sys

import torch


def main():
    out, argv = sys.argv[1], sys.argv[2:]
    work = os.path.abspath(argv[argv.index('--work-dir') + 1])
    writes = []

    def inside(path):
        path = os.path.abspath(os.fspath(path))
        return path.startswith(work + os.sep) or path == work

    real_open, real_makedirs = builtins.open, os.makedirs

    def recording_open(file, mode='r', *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and inside(file) \
                and any(c in mode for c in 'wax+'):
            writes.append(os.path.relpath(os.fspath(file), work))
        return real_open(file, mode, *args, **kwargs)

    def recording_makedirs(name, *args, **kwargs):
        if inside(name):
            writes.append(os.path.relpath(os.fspath(name), work) + '/')
        return real_makedirs(name, *args, **kwargs)

    real_save = torch.save

    def recording_save(obj, f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)) and inside(f):
            writes.append(os.path.relpath(os.fspath(f), work))
        return real_save(obj, f, *args, **kwargs)

    builtins.open, os.makedirs = recording_open, recording_makedirs
    torch.save = recording_save
    try:
        from omnihd_scenes_tpu_torch.tools import train

        state = train.main(argv)
    finally:
        builtins.open, os.makedirs = real_open, real_makedirs
        torch.save = real_save
    torch.save({'writes': writes, 'state': state.model.state_dict()},
               os.path.join(out, f'rank{os.environ["RANK"]}.pt'))


if __name__ == '__main__':
    main()
