"""``tools.train`` on two ranks: ``python -m torch.distributed.run
--standalone --nproc_per_node 2`` with ``--device cpu`` (gloo) on
``configs/synthetic/pointpillars_radar_synth.py`` over a synthetic radar
dataroot of two train and two val samples, one sample a rank (a global
batch of 2), two epochs, the periodic eval at the end:

* the run finishes; its ``done`` record names 2 ranks and gloo;
* both ranks end with equal parameters, equal to the checkpoint's;
* only rank 0 wrote under the work dir (config, log, checkpoint, eval
  files), each log record once;
* the periodic eval (each rank infers its val sample, rank 0 evaluates the
  collected results) equals ``tools.test --eval`` of the same checkpoint
  in one process.

Also: a ``LOCAL_RANK`` with no GPU is an error naming both numbers.
``tests/torch_port_fixtures/dp_families.py`` runs the same launch for
every trained family (about four minutes; not part of this file).

The rank processes (``tests/torch_port_fixtures/dp_train_rank.py``) import
no JAX.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from omnihd_scenes_tpu_torch.devkit.converter import create_newscenes_infos
from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                      generate)
from omnihd_scenes_tpu_torch.tools import test as test_cli

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNTH = str(ROOT / 'configs/synthetic/pointpillars_radar_synth.py')
RANK_SCRIPT = str(ROOT / 'tests/torch_port_fixtures/dp_train_rank.py')


def _options(root):
    return [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl',
            'data.samples_per_device=1']


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dp_cli')
    root, work, out = (str(tmp / d) for d in ('data', 'work', 'out'))
    os.makedirs(out)
    generate(root, 'v1.0-mini', SyntheticConfig(samples_per_scene=2),
             images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', RANK_SCRIPT, out, SYNTH, '--work-dir',
         work, '--device', 'cpu', '--cfg-options', *_options(root)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    return root, work, ranks


def _records(work):
    return [json.loads(line) for line in
            open(os.path.join(work, 'train.log.json'))]


def test_run_finishes_on_two_ranks(launched):
    _, work, _ = launched
    records = _records(work)
    done = records[-1]
    assert done['mode'] == 'done' and done['final_step'] == 2
    assert done['world_size'] == 2 and done['backend'] == 'gloo'
    assert [r['mode'] for r in records].count('env') == 1
    train = [r for r in records if r['mode'] == 'train']
    assert [(r['epoch'], r['iter']) for r in train] == [(0, 0), (1, 0)]


def test_ranks_end_equal_to_the_checkpoint(launched):
    _, work, ranks = launched
    ckpt = torch.load(os.path.join(work, 'ckpts', 'ckpt_2.pt'),
                      weights_only=True)['model']
    for k, v in ckpt.items():
        assert torch.equal(ranks[0]['state'][k], v), k
        assert torch.equal(ranks[1]['state'][k], v), k


def test_only_rank_zero_writes(launched):
    _, work, ranks = launched
    assert ranks[1]['writes'] == []
    wrote = set(ranks[0]['writes'])
    assert {'config.py', 'train.log.json', 'ckpts/'} <= wrote
    assert any(w.startswith('ckpts/ckpt_2.pt') for w in wrote)
    assert any(w.startswith('eval') for w in wrote)
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == ['ckpt_2.pt']


def test_periodic_eval_equals_one_process_eval(launched, tmp_path):
    root, work, _ = launched
    val = [r for r in _records(work) if r['mode'] == 'val']
    assert len(val) == 1
    metrics = test_cli.main([SYNTH, os.path.join(work, 'ckpts'), '--eval',
                             '--out-dir', str(tmp_path), '--device', 'cpu',
                             '--cfg-options', *_options(root)])
    assert set(metrics) <= set(val[0])
    for k, v in metrics.items():
        assert val[0][k] == pytest.approx(v, abs=1e-12), k


def test_a_local_rank_without_a_gpu_is_an_error(monkeypatch):
    """``cuda:LOCAL_RANK`` must exist: the error names both numbers."""
    from omnihd_scenes_tpu_torch.tools.train import rank_device

    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    with pytest.raises(SystemExit, match='LOCAL_RANK 2 .* 2 CUDA device'):
        rank_device(torch.device('cuda'), 2)
    assert rank_device(torch.device('cpu'), 5) == torch.device('cpu')
