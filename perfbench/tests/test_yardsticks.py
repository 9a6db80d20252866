"""The benchmark's frozen yardsticks pinned to the port's originals at a
small size, and the arithmetic of the metrics on known inputs."""

import numpy as np
import pytest
import torch

from perfbench import roofline, stats, traffic
from perfbench.reference import bevformer_t as ref_bf
from perfbench.reference import bevfusion as ref_fu
from perfbench.tests import minis
from perfbench.weights import seeded_state_dict

CPU = torch.device('cpu')


def test_bound_and_peaks_match_the_port():
    from omnihd_scenes_tpu_torch.tools import roofline as port
    assert roofline.PEAK_OPS == port.PEAK_OPS
    assert roofline.HBM_BYTES_PER_S == port.HBM_BYTES_PER_S
    assert stats.PEAK_FLOPS_BF16 == port.PEAK_OPS['bf16']
    for ops, kind, nbytes in ((0, 'bf16', 1e9), (1e12, 'bf16', 1e6),
                              (3e11, 'int8', 2e9), (5e10, 'f32', 1e8)):
        assert roofline.bound(ops, kind, nbytes) == port.bound(ops, kind,
                                                               nbytes)


def _lss_inputs(dtype):
    model = minis.bevfusion_mini()['model']
    lss = model['lss']
    f_h, f_w = ref_fu.feat_hw(lss)
    nx, ny, nz = ref_fu.bev_nx(lss)
    rots, trans = (torch.from_numpy(a) for a in
                   traffic.ring_rig_img2lidar(lss['final_dim']))
    rots, trans = rots.expand(2, *rots.shape), trans.expand(2, *trans.shape)
    minv = torch.linalg.inv_ex(rots)[0]
    mt = -torch.einsum('...ij,...j->...i', minv, trans)
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(2, 6, f_h, f_w, lss['camC'], generator=g).to(dtype)
    depth = torch.rand(2, 6, f_h, f_w, ref_fu.depth_bins(lss),
                       generator=g).to(dtype)
    geom_args = (lss['final_dim'], (f_h, f_w), lss['camera_depth_range'],
                 lss['pc_range'][:3], (lss['grid'],) * 3, (nx, ny, nz))
    solve_x = tuple(lss['cam_solve_x'])
    return feat, depth, minv, mt, geom_args, solve_x


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lss_byte_and_operation_counts_match_the_port(dtype):
    from omnihd_scenes_tpu_torch.kernels import lss_sample as port
    feat, depth, minv, mt, geom_args, solve_x = _lss_inputs(dtype)
    mine = roofline.lss_sample_bev_bytes(feat, depth, minv, mt,
                                         ref_fu._Geom(*geom_args), solve_x,
                                         dtype)
    theirs = port.lss_sample_bev_bytes(feat, depth, minv, mt,
                                       port._Geom(*geom_args), solve_x,
                                       dtype)
    assert mine == theirs > 0
    grad = torch.randn(2, *reversed(geom_args[-1][:2]), geom_args[-1][2],
                       feat.shape[-1]).to(dtype)
    assert roofline.lss_sample_bev_backward_cost(
        grad, feat, depth, minv, mt, ref_fu._Geom(*geom_args),
        solve_x) == port.lss_sample_bev_backward_cost(
        grad, feat, depth, minv, mt, port._Geom(*geom_args), solve_x)


def test_the_reference_view_transform_is_the_ports_plain_one():
    from omnihd_scenes_tpu_torch.kernels import lss_sample as port
    feat, depth, minv, mt, geom_args, solve_x = _lss_inputs(torch.float32)
    mine = ref_fu.gather_cells(feat, depth, *ref_fu.cell_indices(
        *ref_fu.geometry_fields(minv, mt, ref_fu._Geom(*geom_args),
                                solve_x),
        solve_x, geom_args[-1][1], geom_args[-1][0], depth.shape[-1]),
        torch.float32)
    theirs = port.lss_sample_bev_reference(
        feat, depth, minv, mt, port._Geom(*geom_args), solve_x,
        torch.float32)
    torch.testing.assert_close(mine, theirs, rtol=0, atol=0)


def test_rig_matches_the_port():
    from omnihd_scenes_tpu_torch.utils import rig
    for hw in ((544, 960), (64, 96)):
        np.testing.assert_array_equal(traffic.ring_rig_lidar2img(hw),
                                      rig.ring_rig_lidar2img(img_hw=hw))
        for a, b in zip(traffic.ring_rig_img2lidar(hw),
                        rig.ring_rig_img2lidar(img_hw=hw)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_serve_pool_draws_as_the_port_does():
    from omnihd_scenes_tpu_torch.config import (BEVFusionConfig, LSSConfig,
                                                PointPillarsConfig)
    from omnihd_scenes_tpu_torch.serve.synthetic import random_request
    from perfbench.common import dataclass_of
    model = minis.bevfusion_mini()['model']
    mix = minis.serve_mini()
    ours = traffic.serve_pool(mix, model, 2 ** 40 + 9, CPU)
    assert len(ours) == mix['pool']
    port_cfg = dataclass_of(BEVFusionConfig, model, lss=LSSConfig,
                            pillars=PointPillarsConfig)
    theirs = random_request(np.random.RandomState(0), port_cfg,
                            mix['batch'], mix['points'])
    for a, b in zip(ours[0], theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
    points, mask, imgs, rots, trans = ours[0]
    x0, y0 = model['pillars']['point_cloud_range'][:2]
    assert mask.all()
    assert (points[..., 0] >= x0 + 5).all()
    assert (points[..., 0] <= -x0 - 5).all()
    assert (points[..., 1] >= y0 + 2).all()
    assert (points[..., 1] <= -y0 - 2).all()
    assert (points[..., 2] >= -2).all() and (points[..., 2] <= 4).all()
    np.testing.assert_allclose(rots, theirs[3], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(trans, theirs[4], rtol=1e-6, atol=1e-7)
    assert abs(float(imgs.std()) - 1.0) < 0.02
    again = traffic.serve_pool(mix, model, 2 ** 40 + 9, CPU)
    for a, b in zip(ours[1], again[1]):
        np.testing.assert_array_equal(a, b)
    other = traffic.serve_pool(mix, model, 2 ** 40 + 10, CPU)
    assert not np.array_equal(ours[0][2], other[0][2])


def test_stream_plan_draws_as_the_port_does():
    from omnihd_scenes_tpu_torch.config import BEVFormerConfig
    from omnihd_scenes_tpu_torch.serve.synthetic import random_stream_frame
    from perfbench.common import dataclass_of
    model = minis.bevformer_mini()['model']
    mix = minis.stream_mini()
    plan = traffic.StreamPlan(mix, model, 2 ** 45 + 1, CPU)
    theirs = random_stream_frame(np.random.RandomState(0),
                                 dataclass_of(BEVFormerConfig, model),
                                 mix['streams'])
    imgs, can, l2i, has_prev = plan.call(0)
    for a, b in zip((imgs, can, l2i), theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(l2i, theirs[2], rtol=1e-6)
    assert (np.abs(plan.can_bus[..., :2]) <= 1.5).all()
    assert (plan.can_bus[..., 2:-2] == 0).all()
    assert (np.abs(plan.can_bus[..., -1]) <= 3.0).all()
    # Scenes of 4 frames, the 2 streams' starts 2 frames apart.
    flags = [tuple(plan.call(c)[3]) for c in range(6)]
    assert flags == [(False, True), (True, True), (True, False),
                     (True, True), (False, True), (True, True)]
    assert plan.replay(5, 0) == [(4, False), (5, True)]
    assert plan.replay(1, 1) == [(0, True), (1, True)]


def test_percentile_on_known_samples():
    xs = list(range(1, 21))
    assert stats.percentile(xs, 95) == pytest.approx(
        float(np.percentile(xs, 95)))
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_idle_share_on_a_synthetic_timeline():
    device = [(0, 10), (5, 20), (30, 40), (45, 60), (70, 80)]
    assert stats.merge_intervals(device) == [(0, 20), (30, 40), (45, 60),
                                             (70, 80)]
    assert stats.busy_time(device, 0, 50) == 35
    assert stats.idle_gaps(device, 0, 50) == [(20, 30), (40, 45)]
    assert stats.idle_share_pct(35 / 1e9, 50 / 1e9) == pytest.approx(30.0)


def test_mfu_arithmetic():
    assert stats.mfu_pct(1e12, 989, 1.0) == pytest.approx(100.0)
    assert stats.mfu_pct(2e12, 10, 4.0) == pytest.approx(
        100 * 2e12 * 10 / 4.0 / 989e12)


def test_flops_counted_on_meta_equal_flops_on_real_tensors():
    from torch.utils.flop_counter import FlopCounterMode
    model = minis.bevfusion_mini()['model']
    pool = traffic.serve_pool(minis.serve_mini(), model, 7, CPU)
    real = ref_fu.build(model).eval()
    with FlopCounterMode(display=False) as c_real, torch.no_grad():
        real(*[torch.from_numpy(x) for x in pool[0]])
    with torch.device('meta'):
        meta = ref_fu.build(model)
        args = [torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype)
                for x in pool[0]]
    with FlopCounterMode(display=False) as c_meta:
        meta(*args)
    assert c_meta.get_total_flops() == c_real.get_total_flops() > 0


def test_weights_follow_the_ports_initialisation():
    from omnihd_scenes_tpu_torch.models.bevformer.attention import \
        _grid_init_bias
    cfg = minis.bevformer_mini()
    with torch.device('meta'):
        layout = ref_bf.build(cfg['model'])
    a = seeded_state_dict(layout, 11, CPU, torch.bfloat16, cfg['offset_std'])
    b = seeded_state_dict(layout, 11, CPU, torch.bfloat16, cfg['offset_std'])
    c = seeded_state_dict(layout, 12, CPU, torch.bfloat16, cfg['offset_std'])
    assert set(a) == set(layout.state_dict())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a['img_backbone.layer3.0.conv2.weight'].float()
    assert float(w.std()) == pytest.approx(w[0].numel() ** -0.5, rel=0.05)
    assert not torch.equal(w, c['img_backbone.layer3.0.conv2.weight'].float())
    assert (a['img_backbone.bn1.running_var'] == 1).all()
    assert (a['img_backbone.bn1.running_mean'] == 0).all()
    assert (a['img_backbone.bn1.weight'] == 1).all()
    head = 'pts_bbox_head.transformer.decoder.layers.0.cross_attn.'
    off = a[head + 'sampling_offsets.weight'].float()
    assert float(off.std()) == pytest.approx(cfg['offset_std'], rel=0.1)
    np.testing.assert_array_equal(
        a[head + 'sampling_offsets.bias'].float().numpy(),
        torch.from_numpy(_grid_init_bias(8, 1, 4)).bfloat16().float()
        .numpy())
    row = a['pts_bbox_head.positional_encoding.row_embed'].float()
    assert float(row.min()) >= 0 and float(row.max()) <= 1
    emb = a['pts_bbox_head.bev_embedding'].float()
    assert float(emb.std()) == pytest.approx(1.0, rel=0.1)
