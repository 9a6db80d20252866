"""The plain references against the port's modules at a mini width on
the CPU: same parameter names, the same outputs in f32."""

import numpy as np
import pytest
import torch

from perfbench import traffic
from perfbench.common import dataclass_of, dets_mismatch, rel_err
from perfbench.reference import bevformer_t as ref_bf
from perfbench.reference import bevfusion as ref_fu
from perfbench.tests import minis
from perfbench.weights import seeded_state_dict

CPU = torch.device('cpu')


def _port_bevfusion(model):
    from omnihd_scenes_tpu_torch.config import (BEVFusionConfig, LSSConfig,
                                                PointPillarsConfig)
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    return BEVFusion(dataclass_of(BEVFusionConfig, model, lss=LSSConfig,
                                  pillars=PointPillarsConfig)).eval()


def _port_bevformer(model):
    from omnihd_scenes_tpu_torch.config import BEVFormerConfig
    from omnihd_scenes_tpu_torch.models.bevformer import BEVFormerDetector
    return BEVFormerDetector(dataclass_of(BEVFormerConfig, model)).eval()


def test_bevfusion_reference_matches_port():
    cfg = minis.bevfusion_mini()
    model = cfg['model']
    ref = ref_fu.build(model).eval()
    port = _port_bevfusion(model)
    assert set(ref.state_dict()) == set(port.state_dict())
    state = seeded_state_dict(ref, 3, CPU, torch.float32)
    ref.load_state_dict(state)
    port.load_state_dict(state)
    mix = minis.serve_mini()
    req = traffic.serve_pool(mix, model, 2 ** 35 + 1, CPU)[0]
    args = [torch.from_numpy(x) for x in req]
    with torch.no_grad():
        a, b = ref(*args), port(*args)
    for k in ('cls_score', 'bbox_pred', 'dir_pred', 'bev', 'depth',
              'depth_logits'):
        assert rel_err(b[k], a[k]) < 1e-5, k
    anchors = torch.from_numpy(ref_fu.anchors(model['pillars']))
    from omnihd_scenes_tpu_torch.config import DecodeCfg, PointPillarsConfig
    from omnihd_scenes_tpu_torch.models.anchor_head import \
        anchor_head_get_bboxes
    np.testing.assert_array_equal(
        anchors.numpy(),
        dataclass_of(PointPillarsConfig, model['pillars']).anchors())
    maps = [b[k] for k in ('cls_score', 'bbox_pred', 'dir_pred')]
    port_dets = anchor_head_get_bboxes(*maps, anchors,
                                       DecodeCfg(**cfg['decode']))
    ref_dets = ref_fu.anchor_head_get_bboxes(
        *maps, anchors, ref_fu.DecodeCfg(**cfg['decode']))
    assert dets_mismatch(port_dets, ref_dets) == 0.0
    assert bool(port_dets[3].any())


def test_bevformer_reference_matches_port():
    cfg = minis.bevformer_mini()
    model = cfg['model']
    ref = ref_bf.build(model).eval()
    port = _port_bevformer(model)
    assert set(ref.state_dict()) == set(port.state_dict())
    state = seeded_state_dict(ref, 4, CPU, torch.float32, cfg['offset_std'])
    ref.load_state_dict(state)
    port.load_state_dict(state)
    plan = traffic.StreamPlan(minis.stream_mini(), model, 2 ** 36 + 3, CPU)
    imgs, can, l2i, has_prev = (torch.from_numpy(x) for x in plan.call(1))
    prev = torch.randn(imgs.shape[0], model['bev_h'] * model['bev_w'],
                       model['embed_dims'])
    with torch.no_grad():
        a = ref.forward_stream(imgs, can, l2i, prev, has_prev)
        b = port.forward_stream(imgs, can, l2i, prev, has_prev)
    for k in ('bev_embed', 'all_cls_scores', 'all_bbox_preds'):
        assert rel_err(b[k], a[k]) < 1e-5, k
    from omnihd_scenes_tpu_torch.models.bbox_coder import (NMSFreeCoderCfg,
                                                           nms_free_decode)
    dec = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg['decode'].items()}
    port_dets = nms_free_decode(b['all_cls_scores'][:, -1],
                                b['all_bbox_preds'][:, -1],
                                NMSFreeCoderCfg(**dec))
    ref_dets = ref_bf.nms_free_decode(b['all_cls_scores'][:, -1],
                                      b['all_bbox_preds'][:, -1],
                                      ref_bf.NMSFreeCoderCfg(**dec))
    assert dets_mismatch(port_dets, ref_dets) == 0.0


@pytest.mark.parametrize('name', ['bevfusion', 'bevformer_t_r50'])
def test_configuration_builds_the_port(name):
    """Every key of a configuration's model is a field of the port's
    configuration, so the file is the configuration as run."""
    from omnihd_scenes_tpu_torch.config import (BEVFormerConfig,
                                                BEVFusionConfig, LSSConfig,
                                                PointPillarsConfig)
    cfg = minis.config(name)
    if cfg['family'] == 'bevfusion':
        port = dataclass_of(BEVFusionConfig, cfg['model'], lss=LSSConfig,
                            pillars=PointPillarsConfig)
        assert port.lss.feat_hw == ref_fu.feat_hw(cfg['model']['lss'])
        assert port.lss.depth_bins == ref_fu.depth_bins(cfg['model']['lss'])
        assert port.lss.bev_nx == ref_fu.bev_nx(cfg['model']['lss'])
        assert port.pillars.head_hw == ref_fu.head_hw(
            cfg['model']['pillars'])
    else:
        dataclass_of(BEVFormerConfig, cfg['model'])
