"""Pretrained and staged weights (``train/torch_import.py``,
``train/ckpt_remap.py``) and ``check_unused_params`` on the port against
the JAX package, on the CPU.  Nothing is downloaded: the tests write their
own torchvision-format and port checkpoints.

* a torchvision-format ResNet-50 / ResNet-101 ``.pth`` (random tensors
  under torchvision's names, ``fc`` included) imported by both packages:
  the same report (loaded, missing, mismatched and unused keys), and every
  imported tensor equal through the weight bridge; ``pretrained=
  'torchvision://resnet50'`` resolves in a local torch-hub cache only
  (``FileNotFoundError`` otherwise) and lands on BEVFusion's backbone,
  where the JAX package's structural search lands on DepthNet (a recorded
  departure);
* ``import_by_rules`` on keys whose names agree in both packages loads
  the same keys; the mm-style ``load_img_from`` rules (``backbone`` ->
  the model's ResNet) load an mm-style detector checkpoint's backbone in
  the port, where JAX's literal flax path finds none of torchvision's
  names (a recorded departure, the port's docstring says why);
* ``load_lift_from`` / ``load_pts_from`` from port checkpoints against the
  JAX package's ``ckpt_remap`` on the bridged parameters: the same loaded
  set (under the bridge's names), BatchNorm statistics left alone;
* ``make_train_step(..., check_unused_params=True)``: every ``gnorm/*`` of
  a PointPillars step equal to JAX's within 1e-6 relative, both in f64
  (``tests/test_torch_port_pointpillars.py`` holds each gradient leaf
  within 1e-5 of its max).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from omnihd_scenes_tpu.models.detectors import (
    PointPillars as JaxPointPillars)
from omnihd_scenes_tpu.models.resnet import ResNet as JaxResNet
from omnihd_scenes_tpu.train import ckpt_remap as jax_remap
from omnihd_scenes_tpu.train import torch_import as jax_import
from omnihd_scenes_tpu.train.builder import (
    make_loss_fn_generic as jax_make_loss_fn)
from omnihd_scenes_tpu.train.loop import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.models.detectors import PointPillars
from omnihd_scenes_tpu_torch.models.resnet import ResNet
from omnihd_scenes_tpu_torch.train import ckpt_remap
from omnihd_scenes_tpu_torch.train import torch_import
from omnihd_scenes_tpu_torch.train.builder import make_loss_fn_generic
from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                make_train_step,
                                                save_checkpoint)
from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                 make_optimizer)
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, init_weights,
                                             load_state_dict, name_map,
                                             resnet_name_map, torch_to_flax)
from tests.test_torch_port_pointpillars import (MINI, _f64, gt_batch,
                                                pillar_points,
                                                to_port_pillars)
from tests.test_torch_port_weights import (JAX_MINI_CFG, PORT_MINI_CFG,
                                           mini_variables, random_variables)

torch.set_num_threads(1)


def torchvision_sd(depth, seed=0):
    """A torchvision-format ResNet state_dict: the port's ResNet (which
    keeps torchvision's names) with random tensors, plus ``fc``."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g) if v.is_floating_point()
          else v for k, v in ResNet(depth).state_dict().items()}
    sd['fc.weight'] = torch.randn(1000, 2048, generator=g)
    sd['fc.bias'] = torch.randn(1000, generator=g)
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _to_torch_layout(v):
    v = np.asarray(v)
    return v.transpose(3, 2, 0, 1) if v.ndim == 4 else v


@pytest.mark.parametrize('depth', [50, 101])
def test_torchvision_import_equals_jax(depth, tmp_path):
    sd = torchvision_sd(depth)
    pth = str(tmp_path / f'resnet{depth}.pth')
    torch.save(sd, pth)
    loaded = torch_import.load_state_dict(pth)
    target = ResNet(depth).state_dict()
    got, g_rep = torch_import.import_torchvision_resnet(
        loaded, depth, target=target, verbose=False)
    variables = random_variables(JaxResNet(depth=depth, out_indices=(3,)),
                                 np.zeros((1, 32, 32, 3), np.float32))
    want, w_rep = jax_import.import_torchvision_resnet(
        jax_import.load_state_dict(pth), depth,
        target_variables=jax.tree.map(np.asarray, dict(variables)),
        verbose=False)
    assert g_rep == w_rep
    assert len(g_rep['loaded']) == len(resnet_name_map(depth))
    assert g_rep['unused'] == [] and g_rep['missing'] == []
    for key, path in resnet_name_map(depth).items():
        leaf = want
        for k in path:
            leaf = leaf[k]
        np.testing.assert_array_equal(got[key].numpy(),
                                      _to_torch_layout(leaf), err_msg=key)


def test_pretrained_torchvision_scheme(tmp_path, monkeypatch):
    sd = torchvision_sd(50, seed=1)
    hub = tmp_path / 'hub' / 'checkpoints'
    hub.mkdir(parents=True)
    torch.save(sd, str(hub / 'resnet50-0676ba61.pth'))
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    assert torch_import.resolve_pretrained_path(
        'torchvision://resnet50').endswith('resnet50-0676ba61.pth')
    model = BEVFusion(PORT_MINI_CFG)
    merged, reports = torch_import.apply_pretrained(
        model.state_dict(), pretrained='torchvision://resnet50',
        verbose=False)
    rep = reports['pretrained']
    assert len(rep['loaded']) == len(resnet_name_map(50))
    assert not rep['missing'] and not rep['mismatched']
    model.load_state_dict(merged)
    for k in ('conv1.weight', 'layer4.2.bn3.running_var'):
        assert torch.equal(model.state_dict()[f'resnet.{k}'], sd[k])
    # On BEVFusion the JAX package's structural search takes DepthNet (a
    # Conv_0 beside a BasicBlock_0, first in its tree) for the backbone:
    # the stem mismatches and nothing loads (the recorded departure).
    variables = jax.tree.map(np.asarray, dict(mini_variables()))
    assert jax_import.find_backbone_prefix(variables) == (
        'LiftSplatShoot_0', 'DepthNet_0')
    _, j_reports = jax_import.apply_pretrained(
        variables, pretrained='torchvision://resnet50', verbose=False)
    j_rep = j_reports['pretrained']
    assert j_rep['loaded'] == [] and j_rep['mismatched'] == ['conv1.weight']
    assert torch_import.find_backbone_prefix(model.state_dict()) == 'resnet.'
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'nope'))
    with pytest.raises(FileNotFoundError):
        torch_import.resolve_pretrained_path('torchvision://resnet50')


def test_import_by_rules_generic_names_equal_jax():
    """Keys whose names agree in both packages: the same keys load."""
    import flax.linen as fnn

    class Small(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(8, (3, 3), name='stem', use_bias=False)(x)
            x = fnn.BatchNorm(use_running_average=True, name='norm')(x)
            return fnn.Dense(4, name='fc_out')(x)

    target = {'stem.weight': torch.zeros(8, 3, 3, 3),
              'norm.weight': torch.zeros(8), 'norm.bias': torch.zeros(8),
              'norm.running_mean': torch.zeros(8),
              'norm.running_var': torch.ones(8),
              'norm.num_batches_tracked': torch.tensor(0),
              'fc_out.weight': torch.zeros(4, 8),
              'fc_out.bias': torch.zeros(4)}
    rng = np.random.RandomState(1)
    sd = {f'img.{k}': torch.from_numpy(rng.randn(*v.shape).astype(
        np.float32)) for k, v in target.items() if v.is_floating_point()}
    sd['img.norm.num_batches_tracked'] = torch.tensor(7)
    sd['img.stem.weight_extra'] = torch.zeros(2)
    sd['dropped.thing.weight'] = torch.zeros(3, 3)
    sd['img.fc_out.bias'] = torch.zeros(5)                 # wrong shape
    got, g_rep = torch_import.import_by_rules(
        target, sd, rules=(('img', ''),), drop_prefixes=('dropped',),
        verbose=False)
    jtarget = jax.tree.map(np.asarray, dict(Small().init(
        jax.random.PRNGKey(0), np.zeros((1, 8, 8, 3), np.float32))))
    _, j_rep = jax_import.import_by_rules(
        jtarget, _np(sd), rules=(('img', ()),), drop_prefixes=('dropped',),
        verbose=False)
    assert g_rep['loaded'] == j_rep['loaded']
    assert g_rep['skipped'] == j_rep['skipped']
    assert len(g_rep['mismatched']) == len(j_rep['mismatched']) == 1
    assert torch.equal(got['stem.weight'], sd['img.stem.weight'])
    assert torch.equal(got['norm.running_mean'], sd['img.norm.running_mean'])


def test_mm_style_load_img_from(tmp_path):
    """An mm-style detector checkpoint: ``backbone.*`` (torchvision names)
    loads onto BEVFusion's ResNet, ``neck.*`` finds no ``img_neck`` and the
    head is skipped; the JAX package's literal flax paths load none of
    the backbone (the recorded departure)."""
    tv = torchvision_sd(50, seed=2)
    sd = {f'backbone.{k}': v for k, v in tv.items() if not k.startswith('fc')}
    sd['neck.lateral_convs.0.conv.weight'] = torch.zeros(256, 512, 1, 1)
    sd['bbox_head.cls.weight'] = torch.zeros(3, 3)
    pth = str(tmp_path / 'detector.pth')
    torch.save({'state_dict': sd, 'meta': {}}, pth)
    model = BEVFusion(PORT_MINI_CFG)
    merged, reports = torch_import.apply_pretrained(
        model.state_dict(), load_img_from=pth, verbose=False)
    rep = reports['load_img_from']
    n_backbone = len(resnet_name_map(50))
    assert len(rep['loaded']) == n_backbone and not rep['mismatched']
    assert sorted(rep['skipped']) == ['bbox_head.cls.weight',
                                      'neck.lateral_convs.0.conv.weight']
    model.load_state_dict(merged)
    assert torch.equal(model.resnet.layer3[5].conv2.weight,
                       tv['layer3.5.conv2.weight'])
    _, j_reports = jax_import.apply_pretrained(
        jax.tree.map(np.asarray, dict(mini_variables())), load_img_from=pth,
        verbose=False)
    j_rep = j_reports['load_img_from']
    assert j_rep['loaded'] == [] and len(j_rep['skipped']) == len(sd) - sum(
        k.endswith('num_batches_tracked') for k in sd)


def _port_model(cls, cfg, seed, *args):
    model = cls(cfg, *args)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def _checkpoint(model, tmp_path, name):
    state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(1e-3, 10)))
    return save_checkpoint(str(tmp_path / name), state, 1)


def _flax_names(cfg, keys):
    nmap = name_map(cfg)
    return sorted('/'.join(nmap[k][1:]) for k in keys)


@pytest.mark.parametrize('key', ['load_pts_from', 'load_lift_from'])
def test_staged_loads_equal_jax(key, tmp_path):
    """``load_pts_from``: a PointPillars checkpoint into BEVFusion;
    ``load_lift_from``: a BEVFusion checkpoint into BEVFusion, its head
    dropped."""
    if key == 'load_pts_from':
        src_cfg = PORT_MINI_CFG.pillars
        source = _port_model(PointPillars, src_cfg, 4, 8)
    else:
        src_cfg = PORT_MINI_CFG
        source = _port_model(BEVFusion, src_cfg, 4)
    path = _checkpoint(source, tmp_path, 'src')
    target = BEVFusion(PORT_MINI_CFG)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    merged, rep = getattr(ckpt_remap, key)(
        dict(target.named_parameters()),
        torch_import.load_state_dict(path), verbose=False)
    src_sd = source.state_dict()
    for k in rep['loaded']:
        assert torch.equal(merged[k], src_sd[k]), k
    assert len(rep['loaded']) > 20
    assert not any('running' in k for k in rep['loaded'] + rep['skipped'])
    assert target.state_dict().keys() == before.keys()

    j_source = torch_to_flax(src_sd, src_cfg)['params']
    _, j_rep = getattr(jax_remap, key)(mini_variables()['params'], j_source,
                                       verbose=False)
    assert _flax_names(PORT_MINI_CFG, rep['loaded']) == sorted(
        j_rep['loaded'])
    assert len(rep['mismatched']) == len(j_rep['mismatched'])
    assert len(rep['missing']) == len(j_rep['missing'])
    if key == 'load_lift_from':
        assert not any(k.startswith('head.') for k in rep['loaded'])


def test_check_unused_params_gnorm_equals_jax():
    """One PointPillars step in f64 in both packages (JAX's step run
    eagerly: its jitted gradient through the pillar scatter is off on
    the CPU, ROADMAP queue 3 item 8): ``gnorm/<module>`` equal."""
    pcfg = to_port_pillars(MINI)
    pts, mask = pillar_points(5, 8)
    jax_model = JaxPointPillars(MINI)
    variables = random_variables(jax_model, pts, mask, train=False)
    anchors = MINI.anchors()
    batch = {'points': pts, 'points_mask': mask,
             **gt_batch(anchors, np.random.RandomState(9))}

    tx = optax.adamw(1e-3)
    step = jax_make_train_step(jax_make_loss_fn(jax_model, 'pointpillars',
                                                anchors), tx,
                               check_unused_params=True)
    with jax.enable_x64(True), jax.disable_jit():
        params, stats, jbatch = _f64((variables['params'],
                                      variables['batch_stats'], batch))
        state = JaxTrainState(step=np.int32(0), params=params,
                           batch_stats=stats, opt_state=tx.init(params))
        _, _, j_aux = step(state, jbatch)
        j_aux = {k: float(v) for k, v in j_aux.items()}

    model = PointPillars(pcfg, 8)
    load_state_dict(model, flax_to_torch(variables, pcfg))
    model = model.double()
    p_state = create_train_state(model, lambda p: make_optimizer(
        p, make_lr_schedule(1e-3, 10)))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch = {k: v.double() if v.is_floating_point() else v
               for k, v in t_batch.items()}
    _, _, p_aux = make_train_step(
        make_loss_fn_generic(model, 'pointpillars', anchors),
        check_unused_params=True)(p_state, t_batch)
    tops = {k.split('.')[0]: v[1] for k, v in name_map(pcfg).items()}
    got = {k: float(v) for k, v in p_aux.items() if k.startswith('gnorm/')}
    assert set(got) == {f'gnorm/{t}' for t in tops}
    for top, flax_top in tops.items():
        want = j_aux[f'gnorm/{flax_top}']
        assert abs(got[f'gnorm/{top}'] - want) <= 1e-6 * want, top
    assert abs(float(p_aux['grad_norm']) - j_aux['grad_norm']) <= \
        1e-6 * j_aux['grad_norm']
    assert min(got.values()) > 0
