"""The port's configs (and the host-side helpers they use) equal the JAX
package's, and the port imports neither JAX nor the JAX package."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from omnihd_scenes_tpu.models.anchor_head import DecodeCfg as JaxDecodeCfg
from omnihd_scenes_tpu.models.bevformer.detector import (
    BEVFormerConfig as JaxBEVFormerConfig)
from omnihd_scenes_tpu.models.bevfusion import (
    BEVFusionConfig as JaxBEVFusionConfig)
from omnihd_scenes_tpu.models.detectors import (
    PointPillarsConfig as JaxPointPillarsConfig)
from omnihd_scenes_tpu.models.lss import LSSConfig as JaxLSSConfig
from omnihd_scenes_tpu.models.mtl import MTLConfig as JaxMTLConfig
from omnihd_scenes_tpu.train.torch_import import (
    resnet_name_map as jax_resnet_name_map)
from omnihd_scenes_tpu.utils.rig import (
    ring_rig_img2lidar as jax_ring_rig_img2lidar,
    ring_rig_lidar2img as jax_ring_rig_lidar2img)
from omnihd_scenes_tpu_torch import config as port
from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
from omnihd_scenes_tpu_torch.utils.rig import (ring_rig_img2lidar,
                                               ring_rig_lidar2img)
from omnihd_scenes_tpu_torch.weights import resnet_name_map
from tests.test_torch_port_weights import JAX_MINI_CFG, PORT_MINI_CFG

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / \
    'omnihd_scenes_tpu_torch'

PAIRS = [(JaxLSSConfig, port.LSSConfig),
         (JaxPointPillarsConfig, port.PointPillarsConfig),
         (JaxBEVFusionConfig, port.BEVFusionConfig),
         (JaxMTLConfig, port.MTLConfig),
         (JaxBEVFormerConfig, port.BEVFormerConfig)]


@pytest.mark.parametrize('jax_cls,port_cls', PAIRS,
                         ids=[p.__name__ for _, p in PAIRS])
def test_dataclass_fields_and_defaults(jax_cls, port_cls):
    jf = [(f.name, f.type) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.type) for f in dataclasses.fields(port_cls)]
    assert pf == jf
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


def test_decode_cfg_fields_and_defaults():
    assert port.DecodeCfg._fields == JaxDecodeCfg._fields
    assert tuple(port.DecodeCfg()) == tuple(JaxDecodeCfg())


@pytest.mark.parametrize('which', ['default', 'mini'])
def test_derived_properties(which):
    jcfg, pcfg = ((JaxBEVFusionConfig(), port.BEVFusionConfig())
                  if which == 'default' else (JAX_MINI_CFG, PORT_MINI_CFG))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for name in ('feat_hw', 'depth_bins', 'bev_nx'):
        assert getattr(pcfg.lss, name) == getattr(jcfg.lss, name), name
    for name in ('head_hw', 'num_anchors'):
        assert getattr(pcfg.pillars, name) == getattr(jcfg.pillars, name)
    assert pcfg.head_channels == jcfg.head_channels
    np.testing.assert_array_equal(pcfg.pillars.anchors(),
                                  jcfg.pillars.anchors())


@pytest.mark.parametrize('img_hw', [(544, 960), (64, 112)])
def test_ring_rig_matches_jax(img_hw):
    """Both forms of the rig: the LSS (rots, trans) and BEVFormer's
    lidar2img."""
    pairs = list(zip(ring_rig_img2lidar(img_hw=img_hw),
                     jax_ring_rig_img2lidar(img_hw=img_hw)))
    pairs.append((ring_rig_lidar2img(img_hw=img_hw),
                  jax_ring_rig_lidar2img(img_hw=img_hw)))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('depth', [18, 34, 50, 101])
def test_resnet_name_map_matches_jax(depth):
    assert resnet_name_map(depth) == jax_resnet_name_map(depth)


def test_validation_matches():
    for cls in (JaxLSSConfig, port.LSSConfig):
        with pytest.raises(ValueError, match='remat_parts'):
            cls(remat_parts=('nope',))
    for cls in (JaxBEVFusionConfig, port.BEVFusionConfig):
        with pytest.raises(ValueError, match='remat_exclude'):
            cls(remat_exclude=('nope',))
    for cls in (JaxMTLConfig, port.MTLConfig):
        with pytest.raises(ValueError, match='trunk_mode'):
            cls(trunk_mode='nope')


def test_serving_config_is_the_bench_configuration():
    cfg = port.serving_config()
    assert cfg.pillars.pillar_impl == 'dense'
    assert cfg.lss.splat_mode == 'sample'
    assert dataclasses.replace(
        cfg, pillars=port.PointPillarsConfig()) == port.BEVFusionConfig()


def test_rcfusion_option_builds():
    """``rc_fusion='cross_attention'`` (RCFusion's fuser), refused until
    its port, builds the cross-modal fuser in place of the concat conv."""
    from omnihd_scenes_tpu_torch.models.bevfusion import CrossModalFusion

    model = BEVFusion(dataclasses.replace(port.serving_config(),
                                          rc_fusion='cross_attention'))
    assert isinstance(model.fuse, CrossModalFusion)
    assert model.fuse.fuse.conv.in_channels == 256 + 384


@pytest.mark.parametrize('change', [{'rc_fusion': 'nope'}])
def test_unported_options_are_refused(change):
    cfg = dataclasses.replace(port.serving_config(), **change)
    with pytest.raises(NotImplementedError, match='not ported'):
        BEVFusion(cfg)


PORTED = {
    'stem_s2d': lambda c: dataclasses.replace(c, stem_s2d=True),
    'camera_stream': lambda c: dataclasses.replace(c, camera_stream=False),
    'dense_fold': lambda c: dataclasses.replace(c, pillars=dataclasses.replace(
        c.pillars, pillar_impl='dense_fold')),
    'scatter': lambda c: dataclasses.replace(c, lss=dataclasses.replace(
        c.lss, splat_mode='scatter')),
    'remat': lambda c: dataclasses.replace(c, remat=True)}


@pytest.mark.parametrize('option', list(PORTED))
def test_ported_options_build(option):
    """The options refused before their port build at the serving
    configuration's widths, and run at a small one: an eval forward with
    finite head maps, and for remat (training only) a train-mode forward
    and backward."""
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from tests.test_torch_port_remat import small_config

    BEVFusion(PORTED[option](port.serving_config()))
    cfg = PORTED[option](small_config())
    model = BEVFusion(cfg)
    inputs = [None if a is None else torch.from_numpy(a) for a in
              random_request(np.random.RandomState(0), cfg, 1, 200)]
    with torch.set_grad_enabled(option == 'remat'):
        out = model.train(option == 'remat')(*inputs)
    assert bool(torch.isfinite(out['cls_score']).all())
    if option == 'remat':
        out['cls_score'].sum().backward()
        assert model.resnet.conv1.weight.grad is not None


def test_training_configuration_builds():
    """The defaults (sorted pillars, the configuration that trains) build,
    with the sorted encoder under the name the weight bridge maps."""
    model = BEVFusion(port.BEVFusionConfig())
    assert type(model.pillar_encoder).__name__ == 'PillarFeatureNet'
    assert model.state_dict()['pillar_encoder.pfn.0.linear.weight'].shape == (
        64, 13)


def test_package_imports_without_jax():
    """Every module of the port imports with jax, flax, the JAX package,
    OpenCV and matplotlib blocked (the card's machine has neither of the
    last two), the occupancy, multi-task, camera, depth and deployment
    (fuse, export) and data-parallel (``parallel``) modules among them,
    and the tracking eval, the curve plots and the analysis tools, which
    draw with matplotlib only when asked."""
    modules = sorted(
        'omnihd_scenes_tpu_torch.' + '.'.join(
            p.relative_to(PACKAGE).with_suffix('').parts)
        for p in PACKAGE.rglob('*.py'))
    modules = [m.removesuffix('.__init__') for m in modules]
    assert {f'omnihd_scenes_tpu_torch.{m}' for m in (
        'models.occ_head', 'models.mtl', 'ops.ms_deform_attn',
        'eval.occupancy', 'data.image_loading', 'data.depth_loading',
        'models.bevformer.detector', 'data.temporal_dataset',
        'models.bevformer.loss', 'models.hungarian', 'models.dcn',
        'ops.bev_pool', 'data.undistort', 'data.jpeg', 'kernels.rectify',
        'kernels.jpeg_idct',
        'ops.nms_host', 'tools.benchmark', 'serve.fuse', 'serve.export',
        'tools.fuse_conv_bn', 'tools.export', 'serve.inputs',
        'parallel.distributed', 'parallel.mesh', 'eval.tracking',
        'eval.tracking.algo', 'eval.tracking.data_classes',
        'eval.tracking.evaluate', 'eval.tracking.render',
        'eval.detection.render', 'models.centerpoint_head', 'ops.chamfer',
        'data.beam_reduction', 'utils.timing', 'tools.get_flops',
        'tools.analyze_logs', 'tools.misc', 'tools.visualize',
        'tools.download')} <= set(modules)
    code = ('import sys\n'
            'for name in ("jax", "flax", "jaxlib", "optax", '
            '"omnihd_scenes_tpu", "cv2", "matplotlib"):\n'
            '    sys.modules[name] = None\n'
            'import importlib\n'
            f'for m in {modules!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "omnihd_scenes_tpu", "cv2", "matplotlib") '
            'and sys.modules[m] is not None]\n'
            'assert not bad, bad\n'
            'print("ok", len(%r))\n' % (modules,))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=PACKAGE.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


def test_no_jax_import_in_sources():
    """No import of JAX or the JAX package anywhere in the port, and none
    of OpenCV or matplotlib at module level (only inside the function
    that needs it)."""
    pat = re.compile(r'^\s*(import|from)\s+(jax|flax|omnihd_scenes_tpu)\b'
                     r'|^(import|from)\s+(cv2|matplotlib)\b', re.M)
    hits = [str(p) for p in PACKAGE.rglob('*.py') if pat.search(p.read_text())]
    assert not hits, hits
