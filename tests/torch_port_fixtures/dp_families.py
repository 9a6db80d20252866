"""``tools.train`` under torchrun for every trained family, on the CPU:

    python tests/torch_port_fixtures/dp_families.py [family ...]

For each family (tiny synthetic configs; the camera families on a
synthetic dataroot with images, which needs OpenCV) it launches
``python -m torch.distributed.run --standalone --nproc_per_node 2
tests/torch_port_fixtures/dp_train_rank.py`` with ``--device cpu`` (gloo),
one sample a rank, one epoch with the periodic eval, then checks that both
ranks end with equal parameters, that rank 1 wrote nothing under the work
dir, and that the periodic eval (BEVFormer-T has none, as in the JAX
package) equals ``tools.test --eval`` of the checkpoint in one process.
Prints one line a family and exits non-zero if any check fails.  About
four minutes on one core; the CI tests cover the radar family alone
(``tests/test_torch_port_data_parallel_cli.py``).
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
RANK_SCRIPT = str(ROOT / 'tests/torch_port_fixtures/dp_train_rank.py')
RADAR = 'configs/synthetic/pointpillars_radar_synth.py'
FUSION = 'configs/synthetic/bevfusion_synth.py'
# family -> (config, extra --cfg-options)
FAMILIES = {
    'pointpillars': (RADAR, []),
    'radarpillarnet': (RADAR, ['model_type=radarpillarnet']),
    'bevfusion_mtl': (FUSION, []),
    'bevfusion': (FUSION, ['model_type=bevfusion']),
    'rcfusion': (FUSION, ['model_type=rcfusion',
                          'model.rc_fusion=cross_attention']),
    # Camera only: the head sits on the LSS grid (60 x 40), so the pillar
    # config's first stride is 1.
    'lss': (FUSION, ['model_type=lss', 'model.radar_stream=False',
                     'model.lc_fusion=False', 'model.se=False',
                     'model.pillars.second_strides=(1,2,2)']),
    'bevformer': ('configs/synthetic/bevformer_synth.py', []),
}


def _dataroot(tmp):
    from omnihd_scenes_tpu_torch.devkit.converter import (
        create_newscenes_infos)
    from omnihd_scenes_tpu_torch.devkit.synthetic import (SyntheticConfig,
                                                          generate)

    root = os.path.join(tmp, 'data')
    generate(root, 'v1.0-mini', SyntheticConfig(samples_per_scene=2),
             images=True)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def _run(args, env):
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=1200)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])


def check_family(name, root, tmp, env):
    config, extra = FAMILIES[name]
    work, out = (os.path.join(tmp, name, d) for d in ('work', 'out'))
    os.makedirs(out)
    opts = [f'dataroot={root}',
            f'data.train.ann_file={root}/synth_infos_temporal_train.pkl',
            f'data.val.ann_file={root}/synth_infos_temporal_val.pkl',
            'data.samples_per_device=1', 'total_epochs=1',
            'eval_interval=1', 'ckpt_interval=1', *extra]
    _run(['-m', 'torch.distributed.run', '--standalone', '--nproc_per_node',
          '2', RANK_SCRIPT, out, config, '--work-dir', work, '--device',
          'cpu', '--cfg-options', *opts], env)
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    equal = all(torch.equal(ranks[0]['state'][k], v)
                for k, v in ranks[1]['state'].items())
    records = [json.loads(line)
               for line in open(os.path.join(work, 'train.log.json'))]
    val = [r for r in records if r['mode'] == 'val']
    same = None
    if val:
        test = os.path.join(tmp, name, 'test')
        _run(['-m', 'omnihd_scenes_tpu_torch.tools.test', config,
              os.path.join(work, 'ckpts'), '--eval', '--out-dir', test,
              '--device', 'cpu', '--cfg-options', *opts], env)
        with open(os.path.join(test, 'metrics.json')) as f:
            metrics = json.load(f)
        same = all(val[0][k] == v for k, v in metrics.items())
    done = records[-1]
    ok = (equal and not ranks[1]['writes'] and done['world_size'] == 2
          and same is not False and (bool(val) == (name != 'bevformer')))
    print(f'{name}: ok {ok}; ranks equal {equal}; rank 1 wrote '
          f'{ranks[1]["writes"]}; {done["final_step"]} step(s) on '
          f'{done["world_size"]} ranks over {done["backend"]}; periodic '
          f'eval {"equal to one process" if same else same}', flush=True)
    return ok


def main():
    sys.path.insert(0, str(ROOT))
    names = sys.argv[1:] or list(FAMILIES)
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get('PYTHONPATH', '')]))
    with tempfile.TemporaryDirectory() as tmp:
        root = _dataroot(tmp)
        results = [check_family(name, root, tmp, env) for name in names]
    sys.exit(0 if all(results) else 1)


if __name__ == '__main__':
    main()
