"""The port's ``tools/gen_depth_gt.py`` against the JAX package's, on a
synthetic dataroot without images (the port's generator writes the JAX
generator's LiDAR and tables) whose directory is named ``cameras``, so
that the OmniHD layout's path rule (``cameras`` -> ``depth_gt``) applies:

* the CLI writes the files the JAX tool writes, at the same paths, byte
  for byte, with threads;
* its projection equals JAX's ``depth_points_for_cam`` on random clouds;
* each file lands where ``data/depth_loading.py:load_gt_depth`` reads it,
  also for a layout without a ``cameras`` directory (beside the JPEG).
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from omnihd_scenes_tpu.tools import gen_depth_gt as jax_tool  # noqa: E402
from omnihd_scenes_tpu_torch.data.depth_loading import (  # noqa: E402
    depth_gt_path, load_gt_depth)
from omnihd_scenes_tpu_torch.devkit.converter import (  # noqa: E402
    create_newscenes_infos)
from omnihd_scenes_tpu_torch.devkit.synthetic import (  # noqa: E402
    SyntheticConfig, generate)
from omnihd_scenes_tpu_torch.tools import gen_depth_gt as tool  # noqa: E402

HW = (54, 96)


@pytest.fixture(scope='module')
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('depth') / 'cameras')
    generate(root, 'v1.0-mini', SyntheticConfig(
        n_scenes=2, samples_per_scene=2, image_hw=HW, n_radar_points=16,
        n_lidar_points=3000), images=False)
    create_newscenes_infos(root, root, 'synth', version='v1.0-mini',
                           max_sweeps=0)
    return root


def _infos(root, split):
    with open(f'{root}/synth_infos_temporal_{split}.pkl', 'rb') as f:
        return pickle.load(f)['infos']


def _written(root):
    out = {}
    for d, _, files in os.walk(root.replace('cameras', 'depth_gt')):
        for name in files:
            with open(os.path.join(d, name), 'rb') as f:
                out[os.path.join(d, name)] = f.read()
    return out


def test_cli_writes_the_jax_tools_files(dataroot):
    depth_root = dataroot.replace('cameras', 'depth_gt')
    for split in ('train', 'val'):
        for info in _infos(dataroot, split):
            jax_tool.process_info(info, HW)
    want = _written(dataroot)
    shutil.rmtree(depth_root)
    total = sum(tool.main([f'{dataroot}/synth_infos_temporal_{split}.pkl',
                           '--img-h', str(HW[0]), '--img-w', str(HW[1]),
                           '--workers', '3']) for split in ('train', 'val'))
    got = _written(dataroot)
    assert total == len(want) == len(got) > 0
    assert sorted(got) == sorted(want)
    for path, data in want.items():
        assert got[path] == data, path
    assert sum(len(v) for v in got.values()) > 0           # points kept
    info = _infos(dataroot, 'train')[0]
    cam = info['cams']['camera_front']
    dmap = load_gt_depth(cam['data_path'], HW, 1.0)
    assert dmap.shape == HW and float(dmap.max()) > 0


def test_projection_equals_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-40, 40, (5000, 3))
    l2i = np.eye(4)
    l2i[:3, :3] = [[500.0, 48.0, 0.0], [0.0, 27.0, -500.0], [0.0, 1.0, 0.0]]
    l2i[:3, 3] = rng.uniform(-1, 1, 3)
    for hw in (HW, (1080, 1920)):
        got = tool.depth_points_for_cam(pts, l2i, hw)
        want = jax_tool.depth_points_for_cam(pts, l2i, hw)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('cam_path,want', [
    ('/d/cameras/scene_0/camera_front/a.jpg',
     '/d/depth_gt/scene_0/camera_front/a.jpg.bin'),
    ('/d/scene_0/camera_front/a.jpg', '/d/scene_0/camera_front/a.jpg.bin')])
def test_files_go_where_the_loader_reads(cam_path, want):
    assert depth_gt_path(cam_path) == want
