"""Rematerialisation (``BEVFusionConfig.remat`` / ``remat_exclude``,
``LSSConfig.remat_parts``; ``models/layers.py:remat``) in the port, on the
CPU.  remat changes what the backward keeps, not what it computes, so one
training step (forward, the detection and depth losses, backward) of a
small BEVFusion (ResNet18, 6 cameras at 64x96, LSS 16x16x4, dense pillars
64x64, SECOND / FPN 3x16; weights made from a seed) with remat must equal
the step without it bit for bit: the loss, every parameter's gradient and
every BatchNorm's running statistics (one update a step, not a second one
when a checkpointed trunk recomputes).  This holds for every name of
``remat_exclude`` and ``remat_parts`` and under the bf16 policy, whose
parameter copies the recomputation must reuse; each rematted trunk's
forward starts twice (a forward pre-hook counts: the recomputation stops
early once it has what the backward needs), the others once; unknown
names are refused, and
nothing is rematerialised without a gradient being recorded.
"""

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu_torch.config import (BEVFusionConfig, LSSConfig,
                                            PointPillarsConfig)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.serve.synthetic import (random_state_dict,
                                                     random_train_batch)
from omnihd_scenes_tpu_torch.train.amp import bf16_policy
from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic

torch.set_num_threads(1)

TRUNKS = ('second', 'secondfpn', 'resnet', 'fpnc', 'lss')
MODULES = {'second': 'second', 'secondfpn': 'second_fpn', 'resnet': 'resnet',
           'fpnc': 'fpnc', 'lss': 'lss', 'depthnet': 'lss.depthnet',
           'bevencode': 'lss.bev_encoder'}


def small_config(remat=False, exclude=(), parts=()):
    return BEVFusionConfig(
        remat=remat, remat_exclude=exclude, num_views=6, imc=16, lic=48,
        resnet_depth=18,
        lss=LSSConfig(final_dim=(64, 96), downsample=8,
                      camera_depth_range=(1.0, 13.0, 1.0),
                      pc_range=(-16, -16, -3.0, 16, 16, 5.0), grid=2.0,
                      inputC=16, camC=16, outC=16, remat_parts=parts),
        pillars=PointPillarsConfig(
            point_cloud_range=(-16, -16, -3, 16, 16, 5),
            voxel_size=(0.5, 0.5, 8.0), bev_hw=(64, 64), pfn_channels=(16,),
            second_channels=(16, 16, 16), fpn_channels=(16, 16, 16),
            num_classes=4, pillar_impl='dense',
            anchor_ranges=tuple((-16, -16, z, 16, 16, z)
                                for z in (0.9, 1.1, 0.9, 1.5))))


@pytest.fixture(scope='module')
def setup():
    cfg = small_config()
    batch = random_train_batch(np.random.RandomState(0), cfg, 2,
                               n_points=400, max_gt=6)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return random_state_dict(cfg, seed=0), batch


def step(cfg, sd, batch, policy=False):
    """One forward + loss + backward in train mode -> (loss, {name:
    grad}, {name: buffer}, {trunk: forward calls})."""
    model = BEVFusion(cfg)
    model.load_state_dict(sd)
    model.train()
    calls = dict.fromkeys(MODULES, 0)
    for name, path in MODULES.items():
        def count(*_, name=name):
            calls[name] += 1
        model.get_submodule(path).register_forward_pre_hook(count)
    loss_fn = make_loss_fn_generic(model, 'bevfusion', cfg.pillars.anchors())
    if policy:
        loss_fn = bf16_policy(loss_fn)
    loss, _ = loss_fn(model, dict(model.named_parameters()), batch)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.detach(), grads, dict(model.named_buffers()), calls


@pytest.fixture(scope='module')
def baseline(setup):
    return step(small_config(), *setup)


def assert_bit_equal(got, want):
    loss, grads, buffers, _ = got
    assert torch.equal(loss, want[0])
    assert grads.keys() == want[1].keys()
    for k, g in grads.items():
        assert g is not None, k
        assert torch.equal(g, want[1][k]), k
    for k, b in buffers.items():
        assert torch.equal(b, want[2][k]), k


CASES = ([('all', (), ())]
         + [(f'exclude-{t}', (t,), ()) for t in TRUNKS]
         + [(f'parts-{p}', ('lss',), (p,)) for p in ('depthnet', 'bevencode')]
         + [('parts-both', ('lss',), ('depthnet', 'bevencode'))])


@pytest.mark.parametrize('name,exclude,parts', CASES,
                         ids=[c[0] for c in CASES])
def test_remat_step_is_bit_equal(setup, baseline, name, exclude, parts):
    got = step(small_config(True, exclude, parts), *setup)
    assert_bit_equal(got, baseline)
    rematted = set(parts) | {t for t in TRUNKS if t not in exclude}
    for trunk, n in got[3].items():
        if trunk in ('depthnet', 'bevencode'):
            # Inside a rematted LSS they recompute with it.
            want = 1 + (trunk in rematted or 'lss' in rematted)
        else:
            want = 1 + (trunk in rematted)
        assert n == want, (trunk, n, want)


def test_remat_under_the_bf16_policy(setup):
    cfg_sd, batch = setup
    want = step(small_config(), cfg_sd, batch, policy=True)
    got = step(small_config(True, parts=('depthnet',)), cfg_sd, batch,
               policy=True)
    assert_bit_equal(got, want)
    assert got[3]['resnet'] == 2


def test_no_remat_without_a_gradient(setup):
    sd, batch = setup
    model = BEVFusion(small_config(True, parts=('depthnet',)))
    model.load_state_dict(sd)
    calls = []
    model.resnet.register_forward_pre_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        model.train()(batch['points'], batch['points_mask'], batch['imgs'],
                      batch['img2lidar_rots'], batch['img2lidar_trans'])
    assert calls == [1]


@pytest.mark.parametrize('bad', [
    lambda: BEVFusionConfig(remat_exclude=('lss', 'nope')),
    lambda: LSSConfig(remat_parts=('depth_net',))], ids=['exclude', 'parts'])
def test_unknown_names_are_refused(bad):
    with pytest.raises(ValueError, match='not in'):
        bad()
