"""Configurations of the benchmark's files cut to a size the CPU tests
hold: the same keys, the same paths, small widths."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def config(name: str) -> dict:
    return json.loads((ROOT / 'perfbench' / 'configs'
                       / f'{name}.json').read_text())


def bevfusion_mini() -> dict:
    cfg = copy.deepcopy(config('bevfusion'))
    m = cfg['model']
    m.update(imc=32, lic=48, resnet_depth=18, num_views=6)
    m['lss'].update(final_dim=[64, 96], grid=4.0, camC=8, outC=16,
                    camera_depth_range=[1.0, 30.0, 1.0])
    m['pillars'].update(voxel_size=[2.0, 2.0, 8.0], bev_hw=[40, 60],
                        pfn_channels=[16], second_layer_nums=[1, 1, 1],
                        second_channels=[16, 32, 32],
                        fpn_channels=[16, 16, 16])
    cfg['name'] = 'bevfusion_mini'
    cfg['decode'].update(nms_pre=100, max_num=50)
    cfg['train']['model']['pillars'].update(max_voxels=300,
                                            max_points_per_voxel=5)
    return cfg


def serve_mini() -> dict:
    mix = json.loads((ROOT / 'perfbench' / 'traffic'
                      / 'serve_b4.json').read_text())
    mix.update(batch=2, pool=2, points=500, warmup=1, checked=2)
    return mix


def bevformer_mini() -> dict:
    cfg = copy.deepcopy(config('bevformer_t_r50'))
    cfg['model'].update(bev_h=10, bev_w=15, num_query=20, embed_dims=32,
                        encoder_layers=1, decoder_layers=2, resnet_depth=18,
                        img_hw=[64, 96])
    cfg['decode'].update(max_num=30)
    cfg['name'] = 'bevformer_t_mini'
    return cfg


def stream_mini() -> dict:
    mix = json.loads((ROOT / 'perfbench' / 'traffic'
                      / 'stream_b4.json').read_text())
    mix.update(streams=2, scene_frames=4, pool=2, can_bus_table=8, warmup=1,
               checked=2)
    return mix


def train_mini() -> dict:
    mix = json.loads((ROOT / 'perfbench' / 'traffic'
                      / 'train_b1.json').read_text())
    mix.update(points=500, gt_boxes=8, pool=4)
    return mix


# The cells of the benchmark and their mini stand-ins.
MINI_CELLS = {
    'bevfusion_serve_b4': ('bevfusion_mini', bevfusion_mini, 'serve_mini',
                           serve_mini),
    'bevformer_r50_stream_b4': ('bevformer_t_mini', bevformer_mini,
                                'stream_mini', stream_mini),
    'bevfusion_train_b1': ('bevfusion_mini', bevfusion_mini, 'train_mini',
                           train_mini),
}


def mini_root(tmp: Path) -> Path:
    """A checkout's benchmark files under ``tmp`` with one mini cell
    beside each of the manifest's cells, added the way a later change
    adds one: new files and new manifest entries.  A mini cell takes its
    cell's per-layer metrics and limits."""
    import shutil
    for d in ('configs', 'traffic', 'metrics', 'end_to_end', 'drivers',
              'limits'):
        shutil.copytree(ROOT / 'perfbench' / d, tmp / 'perfbench' / d)
    manifest = json.loads((ROOT / 'BENCHMARK.json').read_text())
    names = {}
    for cell, (cfg_name, cfg, mix_name, mix) in MINI_CELLS.items():
        if cell not in {w['name'] for w in manifest['workloads']}:
            continue
        mini = f'{cell}_mini'
        names[cell] = mini
        (tmp / 'perfbench' / 'configs' / f'{cfg_name}.json').write_text(
            json.dumps(cfg()))
        (tmp / 'perfbench' / 'traffic' / f'{mix_name}.json').write_text(
            json.dumps(mix()))
        limits = ROOT / 'perfbench' / 'limits' / f'{cell}.json'
        if limits.exists():
            shutil.copy(limits, tmp / 'perfbench' / 'limits'
                        / f'{mini}.json')
        manifest['configs'].append(
            {'name': cfg_name, 'source': 'tests',
             'file': f'perfbench/configs/{cfg_name}.json', 'reduced': [],
             'why': 'a mini stand-in'})
        manifest['workloads'].append(
            {'name': mini, 'config': cfg_name, 'traffic': mix_name,
             'chips': 1, 'why': 'a mini stand-in'})
    for m in manifest['end_to_end'] + manifest['per_layer']:
        if 'workloads' in m:
            m['workloads'] += [names[w] for w in m['workloads']
                               if w in names]
    (tmp / 'BENCHMARK.json').write_text(json.dumps(manifest, indent=1))
    return tmp

