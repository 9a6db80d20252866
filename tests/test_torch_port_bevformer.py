"""BEVFormer-T on the port against the JAX package, on the CPU in f32,
with the JAX variables of ``configs/synthetic/bevformer_synth.py``'s
model (perturbed so that no kernel is zero) bridged by
``weights.flax_to_torch``:

* the attention modules: TSA with and without history, SCA masked dense
  and capped (with and without dropped hits), the decoder's deformable
  cross-attention and self-attention; ``sca_cap_overflow`` and
  ``sca_overflow_for_rig``;
* the encoder pieces: reference points, ``point_sampling`` on the ring
  rig, the encoder with one stream with history and one at a scene
  boundary;
* ``compute_bev_shift`` (``can_bus[-2]`` in radians, read as degrees as
  JAX reads it) and ``rotate_bev``;
* the box coder: codes both ways and ``nms_free_decode`` (kept rows
  matched as multisets, padding when max_num exceeds the candidates);
* ``forward_stream`` over 3 frames with a scene boundary, the previous
  BEV carried by each side; the queue forward (against JAX's stream of
  its frames, which JAX's own tests hold equal to JAX's queue forward);
  the queue forward against streaming; B=2 streams against each stream
  alone;
* the weight bridge both ways (every leaf of the flax tree, whose shapes
  come from an abstract JAX init), and the flax initialisation.

The variables are the port's seeded initialisation carried to flax and
perturbed (a concrete JAX init of this model takes ~30 s on one core).
Bound: 1e-4 of max|ref| (the JAX side jitted, which divides by constants
as a multiply by the reciprocal, as the port does).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnihd_scenes_tpu.models import bbox_coder as jax_coder
from omnihd_scenes_tpu.models.bevformer import attention as jax_att
from omnihd_scenes_tpu.models.bevformer import encoder as jax_enc
from omnihd_scenes_tpu.models.bevformer import transformer as jax_tr
from omnihd_scenes_tpu.models.bevformer.detector import (
    BEVFormerConfig as JaxCfg, BEVFormerDetector as JaxDetector,
    sca_overflow_for_rig as jax_sca_overflow_for_rig)
from omnihd_scenes_tpu.train.config import Config as JaxConfig
from omnihd_scenes_tpu.utils.rig import (
    ring_rig_lidar2img as jax_ring_rig_lidar2img)
from omnihd_scenes_tpu_torch.config import BEVFormerConfig
from omnihd_scenes_tpu_torch.models import bbox_coder
from omnihd_scenes_tpu_torch.models.bevformer import (
    BEVFormerDetector, sca_overflow_for_rig)
from omnihd_scenes_tpu_torch.models.bevformer.attention import (
    sca_cap_overflow)
from omnihd_scenes_tpu_torch.models.bevformer.encoder import (
    get_reference_points_2d, get_reference_points_3d, point_sampling)
from omnihd_scenes_tpu_torch.models.bevformer.transformer import (
    compute_bev_shift, rotate_bev)
from omnihd_scenes_tpu_torch.train.builder import init_model
from omnihd_scenes_tpu_torch.utils.rig import ring_rig_lidar2img
from omnihd_scenes_tpu_torch.weights import (flax_to_torch, load_state_dict,
                                             name_map, torch_to_flax)

torch.set_num_threads(1)
TOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNTH = JaxConfig.fromfile(str(ROOT / 'configs/synthetic/bevformer_synth.py'))
KW = SYNTH.model.to_dict()
CFG = BEVFormerConfig(**KW)
JCFG = JaxCfg(**KW)
NQ = CFG.bev_h * CFG.bev_w
C = CFG.embed_dims
BEV_SHAPES = ((CFG.bev_h, CFG.bev_w),)
IMG_HW = CFG.img_hw


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


def _perturb(variables, seed=1):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if 'var' in jax.tree_util.keystr(path):
            return (np.abs(rng.normal(0, 0.1, x.shape)) + 0.5).astype(
                np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _frames(n=3, seed=0):
    """n frames of one stream: images, relative can_bus (frame 0 and the
    scene boundary at frame 2 have no history), the ring rig moved a
    little per frame."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, CFG.num_cams, *IMG_HW, 3).astype(np.float32)
    cbs = np.zeros((n, 18), np.float32)
    cbs[:, :2] = rng.uniform(-1.5, 1.5, (n, 2))
    cbs[:, -2] = rng.uniform(0.0, 2 * np.pi, n)          # radians
    cbs[:, -1] = rng.uniform(-4.0, 4.0, n)               # degrees (delta)
    l2i = np.stack([jax_ring_rig_lidar2img(img_hw=IMG_HW)
                    * (1 + 0.01 * i) for i in range(n)]).astype(np.float32)
    has_prev = np.array([False, True, False][:n])
    return imgs, cbs, l2i, has_prev


def jax_variable_shapes(jm):
    """The flax tree of ``jm`` (shapes and dtypes, no values)."""
    imgs, cbs, l2i, _ = _frames(1)
    return jax.eval_shape(lambda k: jm.init(
        k, imgs[0], cbs[0], l2i[0], np.zeros((NQ, C), np.float32),
        np.asarray(False), method=JaxDetector.forward_stream),
        jax.random.PRNGKey(0))


def bridged_variables(cfg, seed=0):
    """flax variables of the port's seeded initialisation, perturbed."""
    model = init_model(BEVFormerDetector(cfg),
                       torch.Generator().manual_seed(seed))
    return _perturb(torch_to_flax(model.state_dict(), cfg))


@pytest.fixture(scope='module')
def models():
    jm = JaxDetector(JCFG)
    variables = bridged_variables(CFG)
    pm = BEVFormerDetector(CFG)
    load_state_dict(pm, flax_to_torch(variables, CFG))
    pm.eval()
    stream = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=JaxDetector.forward_stream))
    return dict(jm=jm, v=variables, pm=pm, stream=stream,
                p=variables['params']['pts_bbox_head']['transformer'])


def _enc_layer(models):
    return models['pm'].pts_bbox_head.transformer.encoder.layers[0]


def _dec_layer(models):
    return models['pm'].pts_bbox_head.transformer.decoder.layers[0]


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize('has_prev', [True, False])
def test_temporal_self_attention(models, has_prev):
    rng = np.random.RandomState(10)
    query = rng.randn(2, NQ, C).astype(np.float32)
    pos = rng.randn(NQ, C).astype(np.float32)
    ref = get_reference_points_2d(CFG.bev_h, CFG.bev_w)
    if has_prev:
        value = np.stack([rng.randn(2, NQ, C).astype(np.float32), query], 1)
        shift = rng.uniform(-0.05, 0.05, (2, 1, 1, 2)).astype(np.float32)
        refs = np.stack([ref[None] + shift, np.tile(ref[None], (2, 1, 1, 1))],
                        1)
    else:
        value = np.stack([query, query], 1)
        refs = np.tile(ref[None, None], (2, 2, 1, 1, 1))
    p = models['p']['encoder']['layer_0']['tsa']
    mod = jax_att.TemporalSelfAttention(C, 8, 1, 4)
    want = jax.jit(jax.vmap(lambda q, v, r: mod.apply(
        {'params': p}, q, v, r, BEV_SHAPES, query_pos=pos)))(
            query, value, refs)
    got = _enc_layer(models).tsa(t(query), t(value), t(refs), BEV_SHAPES,
                                 query_pos=t(pos))
    assert_close(got, want)


def _sca_inputs(seed=11):
    rng = np.random.RandomState(seed)
    h, w = IMG_HW[0] // 32, IMG_HW[1] // 32
    query = rng.randn(2, NQ, C).astype(np.float32)
    cam_values = rng.randn(2, CFG.num_cams, h * w, C).astype(np.float32)
    l2i = np.stack([ring_rig_lidar2img(img_hw=IMG_HW),
                    ring_rig_lidar2img(img_hw=IMG_HW) * 1.02])
    ref_3d = get_reference_points_3d(CFG.bev_h, CFG.bev_w, 4, 8.0)
    rpc, mask = point_sampling(t(ref_3d), CFG.pc_range, t(l2i), IMG_HW)
    return query, cam_values, rpc.numpy(), mask.numpy(), ((h, w),), l2i


def test_point_sampling_and_reference_points(models):
    z = CFG.pc_range[5] - CFG.pc_range[2]
    np.testing.assert_array_equal(
        get_reference_points_3d(CFG.bev_h, CFG.bev_w, 4, z),
        jax_enc.get_reference_points_3d(CFG.bev_h, CFG.bev_w, 4, z))
    np.testing.assert_array_equal(
        get_reference_points_2d(CFG.bev_h, CFG.bev_w),
        jax_enc.get_reference_points_2d(CFG.bev_h, CFG.bev_w))
    _, _, rpc, mask, _, l2i = _sca_inputs()
    ref_3d = jax_enc.get_reference_points_3d(CFG.bev_h, CFG.bev_w, 4, z)
    fn = jax.jit(jax.vmap(lambda l: jax_enc.point_sampling(
        ref_3d, CFG.pc_range, l, IMG_HW)))
    want_rpc, want_mask = fn(l2i)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert 0.1 < mask.any(-1).mean() < 0.5       # cameras see the BEV
    assert_close(rpc, want_rpc)


def _sca_caps(mask):
    """A cap no camera's hits exceed, and one below the largest count."""
    most = int(mask.any(-1).sum(-1).max())
    return most / NQ, 0.5 * most / NQ


@pytest.mark.parametrize('form', ['dense', 'cap', 'cap_overflow'])
def test_spatial_cross_attention(models, form):
    query, cam_values, rpc, mask, shapes, _ = _sca_inputs()
    fits, drops = _sca_caps(mask)
    cap = {'dense': 1.0, 'cap': fits, 'cap_overflow': drops}[form]
    overflow = sca_cap_overflow(t(mask), cap)
    assert (overflow > 0).all() == (form == 'cap_overflow')
    np.testing.assert_array_equal(
        overflow.numpy(), [int(jax_att.sca_cap_overflow(m, cap))
                           for m in mask])
    p = models['p']['encoder']['layer_0']['sca']
    mod = jax_att.SpatialCrossAttention(C, CFG.num_cams, 8, 1, 8,
                                        query_cap=cap)
    want = jax.jit(jax.vmap(lambda q, v, r, m: mod.apply(
        {'params': p}, q, v, r, m, shapes)))(query, cam_values, rpc, mask)
    sca = _enc_layer(models).sca
    sca.query_cap = cap
    try:
        got = sca(t(query), t(cam_values), t(rpc), t(mask), shapes)
        if form == 'cap':                     # no drop: the dense result
            sca.query_cap = 1.0
            assert_close(got, sca(t(query), t(cam_values), t(rpc), t(mask),
                                  shapes))
    finally:
        sca.query_cap = CFG.sca_query_cap
    assert_close(got, want)


def test_sca_overflow_for_rig(models):
    l2i = ring_rig_lidar2img(img_hw=IMG_HW)
    for cap in (1.0, 0.375, 0.1, 0.02):
        cfg = dataclasses.replace(CFG, sca_query_cap=cap)
        jcfg = dataclasses.replace(JCFG, sca_query_cap=cap)
        assert sca_overflow_for_rig(cfg, l2i) == jax_sca_overflow_for_rig(
            jcfg, l2i)
    assert sca_overflow_for_rig(dataclasses.replace(CFG, sca_query_cap=0.02),
                                l2i) > 0


def test_decoder_attention(models):
    rng = np.random.RandomState(12)
    nq = CFG.num_query
    query = rng.randn(2, nq, C).astype(np.float32)
    pos = rng.randn(2, nq, C).astype(np.float32)
    bev = rng.randn(2, NQ, C).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (2, nq, 1, 2)).astype(np.float32)
    p = models['p']['decoder']['layer_0']
    cross = jax_att.CustomMSDeformableAttention(C, 8, 1, 4)
    want = jax.jit(jax.vmap(lambda q, v, r, qp: cross.apply(
        {'params': p['cross_attn']}, q, v, r, BEV_SHAPES, query_pos=qp)))(
            query, bev, ref, pos)
    layer = _dec_layer(models)
    assert_close(layer.cross_attn(t(query), t(bev), t(ref), BEV_SHAPES,
                                  query_pos=t(pos)), want)
    mha = jax_att.MultiheadAttention(C, 8)
    want = jax.jit(jax.vmap(lambda q, qp: mha.apply(
        {'params': p['self_attn']}, q, qp)))(query, pos)
    assert_close(layer.self_attn(t(query), t(pos)), want)


def test_encoder_streams_with_and_without_history(models):
    """Stream 0 has history (shifted references, the previous BEV in the
    queue), stream 1 is at a scene boundary ([current, current])."""
    rng = np.random.RandomState(13)
    query = rng.randn(2, NQ, C).astype(np.float32)
    pos = rng.randn(NQ, C).astype(np.float32)
    _, cam_values, _, _, shapes, l2i = _sca_inputs()
    prev = rng.randn(2, NQ, C).astype(np.float32)
    shift = rng.uniform(-0.05, 0.05, (2, 2)).astype(np.float32)
    has_prev = np.array([True, False])
    enc = jax_enc.BEVFormerEncoder(
        num_layers=1, embed_dims=C, bev_h=CFG.bev_h, bev_w=CFG.bev_w,
        pc_range=CFG.pc_range, num_cams=CFG.num_cams)
    want = jax.jit(jax.vmap(lambda q, v, l, pb, s, hp: enc.apply(
        {'params': models['p']['encoder']}, q, pos, v, l, IMG_HW, shapes,
        prev_bev=pb, shift=s, has_prev=hp)))(
            query, cam_values, l2i, prev, shift, has_prev)
    got = models['pm'].pts_bbox_head.transformer.encoder(
        t(query), t(pos), t(cam_values), t(l2i), IMG_HW, shapes,
        prev_bev=t(prev), shift=t(shift), has_prev=t(has_prev))
    assert_close(got, want)


# -- transformer pieces ------------------------------------------------------

def test_bev_shift_reads_radians_as_degrees():
    """``can_bus[-2]`` holds the patch angle in radians
    (``finalize_can_bus``); JAX's shift reads it as degrees (upstream
    converts it).  The port mirrors JAX (ROADMAP queue 3 item 12)."""
    rng = np.random.RandomState(14)
    cbs = np.zeros((16, 18), np.float32)
    cbs[:, :2] = rng.uniform(-3, 3, (16, 2))
    cbs[:, -2] = rng.uniform(0, 2 * np.pi, 16)
    grid = (0.5, 0.5)
    want = jax.jit(jax.vmap(lambda c: jax_tr.compute_bev_shift(
        c, grid, (CFG.bev_h, CFG.bev_w))))(cbs)
    got = compute_bev_shift(t(cbs), grid, (CFG.bev_h, CFG.bev_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    converted = cbs.copy()
    converted[:, -2] = np.rad2deg(cbs[:, -2])
    assert not np.allclose(
        compute_bev_shift(t(converted), grid, (CFG.bev_h, CFG.bev_w)).numpy(),
        got.numpy(), atol=1e-3)


def test_rotate_bev():
    rng = np.random.RandomState(15)
    bev = rng.randn(3, NQ, C).astype(np.float32)
    angles = np.array([0.0, 7.5, -33.0], np.float32)
    want = jax.jit(jax.vmap(lambda b, a: jax_tr.rotate_bev(
        b, a, (CFG.bev_h, CFG.bev_w))))(bev, angles)
    got = rotate_bev(t(bev), t(angles), (CFG.bev_h, CFG.bev_w))
    assert_close(got, want)
    torch.testing.assert_close(got[0], t(bev[0]), rtol=0, atol=1e-6)


# -- box coder ---------------------------------------------------------------

def test_box_codes_match_jax():
    rng = np.random.RandomState(16)
    boxes = np.concatenate([rng.uniform(-50, 50, (20, 3)),
                            rng.uniform(0.5, 5, (20, 3)),
                            rng.uniform(-3, 3, (20, 3))], -1).astype(
        np.float32)
    code = bbox_coder.normalize_bbox(t(boxes))
    assert_close(code, jax_coder.normalize_bbox(boxes))
    assert_close(bbox_coder.denormalize_bbox(code),
                 jax_coder.denormalize_bbox(np.asarray(code)))
    assert_close(bbox_coder.denormalize_bbox(code), boxes)


def kept_rows(boxes, scores, labels, valid):
    """The kept rows (box, score, 100 * label)."""
    rows = np.concatenate([np.asarray(boxes), np.asarray(scores)[:, None],
                           100.0 * np.asarray(labels)[:, None]], -1)
    return rows[np.asarray(valid)].astype(np.float64)


def assert_same_detections(got, want):
    """Kept rows matched as multisets (``chip_smoke.py:kept_row_distance``):
    nearly tied scores may leave top-k in another order, so every kept
    row of each side must have a row of the other within 1e-4 of its
    column's largest magnitude (boxes) or of 1 (scores, labels)."""
    g = kept_rows(*[_np(x) for x in got])
    w = kept_rows(*want)
    assert g.shape == w.shape and g.shape[0] > 0
    gain = np.concatenate([np.maximum(np.abs(w[:, :-2]).max(0), 1.0),
                           np.ones(2)])
    d = (np.abs(g[:, None] - w[None]) / gain).max(-1)
    assert max(d.min(1).max(), d.min(0).max()) <= TOL


@pytest.mark.parametrize('max_num,thr', [(300, None), (50, 0.3)])
def test_nms_free_decode(max_num, thr):
    rng = np.random.RandomState(17)
    cls = rng.randn(2, 40, 4).astype(np.float32)
    preds = np.concatenate([rng.uniform(-80, 80, (2, 40, 2)),
                            rng.uniform(-1, 1, (2, 40, 2)),
                            rng.uniform(-12, 12, (2, 40, 1)),
                            rng.uniform(-1, 1, (2, 40, 5))], -1).astype(
        np.float32)
    jcfg = jax_coder.NMSFreeCoderCfg(max_num=max_num, score_threshold=thr)
    pcfg = bbox_coder.NMSFreeCoderCfg(max_num=max_num, score_threshold=thr)
    assert tuple(pcfg) == tuple(jcfg)
    got = bbox_coder.nms_free_decode(t(cls), t(preds), pcfg)
    for i in range(2):
        want = jax.jit(lambda c, p: jax_coder.nms_free_decode(c, p, jcfg))(
            cls[i], preds[i])
        assert all(g.shape[1:] == np.shape(w) for g, w in zip(got, want))
        assert_same_detections([g[i] for g in got],
                               [np.asarray(w) for w in want])


# -- the detector ------------------------------------------------------------

def _decode_port(out):
    return bbox_coder.nms_free_decode(out['all_cls_scores'][:, -1],
                                      out['all_bbox_preds'][:, -1])


def test_forward_stream_three_frames(models):
    """Three frames of one stream (the third at a scene boundary), each
    side carrying its own previous BEV."""
    imgs, cbs, l2i, has_prev = _frames()
    j_prev = np.zeros((NQ, C), np.float32)
    p_prev = torch.zeros(1, NQ, C)
    for i in range(3):
        want = models['stream'](models['v'], imgs[i], cbs[i], l2i[i], j_prev,
                                np.asarray(has_prev[i]))
        with torch.no_grad():
            got = models['pm'].forward_stream(
                t(imgs[i:i + 1]), t(cbs[i:i + 1]), t(l2i[i:i + 1]), p_prev,
                t(has_prev[i:i + 1]))
        for key in ('bev_embed', 'all_cls_scores', 'all_bbox_preds'):
            assert_close(got[key][0], want[key])
        assert_same_detections(
            [x[0] for x in _decode_port(got)],
            [np.asarray(x) for x in jax_coder.nms_free_decode(
                want['all_cls_scores'][-1], want['all_bbox_preds'][-1])])
        j_prev, p_prev = want['bev_embed'], got['bev_embed']


@pytest.fixture(scope='module')
def queue_outputs(models):
    """The port's queue forward over two frames, and JAX's stream of them
    (JAX's queue forward is its stream: ``test_bevformer.py``)."""
    imgs, cbs, l2i, _ = _frames(2)
    has_prev = np.array([False, True])
    bev0 = models['stream'](models['v'], imgs[0], cbs[0], l2i[0],
                            np.zeros((NQ, C), np.float32),
                            np.asarray(False))['bev_embed']
    want = models['stream'](models['v'], imgs[1], cbs[1], l2i[1], bev0,
                            np.asarray(True))
    with torch.no_grad():
        got = models['pm'](t(imgs[None]), t(cbs[None]), t(l2i[None]),
                           t(has_prev[None]))
    return (imgs, cbs, l2i, has_prev), want, got


def test_queue_forward(queue_outputs):
    _, want, got = queue_outputs
    for key in ('bev_embed', 'all_cls_scores', 'all_bbox_preds'):
        assert_close(got[key][0], want[key])


def test_queue_forward_equals_streaming(models, queue_outputs):
    """The queue's history replay is the stream of its frames, on the
    port alone."""
    (imgs, cbs, l2i, _), _, queue = queue_outputs
    pm = models['pm']
    with torch.no_grad():
        bev0 = pm.pts_bbox_head.get_bev(
            pm.extract_img_feat(t(imgs[:1])), t(cbs[:1]), t(l2i[:1]), IMG_HW,
            prev_bev=torch.zeros(1, NQ, C), has_prev=torch.tensor([False]))
        got = pm.forward_stream(t(imgs[1:2]), t(cbs[1:2]), t(l2i[1:2]), bev0,
                                torch.tensor([True]))
    for key in ('bev_embed', 'all_cls_scores', 'all_bbox_preds'):
        torch.testing.assert_close(got[key], queue[key], rtol=0, atol=1e-5)


def test_two_streams_equal_each_alone(models):
    imgs, cbs, l2i, _ = _frames(2, seed=3)
    rng = np.random.RandomState(18)
    prev = t(rng.randn(2, NQ, C).astype(np.float32))
    has_prev = torch.tensor([True, False])
    pm = models['pm']
    with torch.no_grad():
        both = pm.forward_stream(t(imgs), t(cbs), t(l2i), prev, has_prev)
        for i in range(2):
            one = pm.forward_stream(t(imgs[i:i + 1]), t(cbs[i:i + 1]),
                                    t(l2i[i:i + 1]), prev[i:i + 1],
                                    has_prev[i:i + 1])
            for key, v in one.items():
                assert_close(both[key][i], v[0].numpy())


# -- weights -----------------------------------------------------------------

def test_weight_round_trip(models):
    """The bridge maps every leaf of JAX's tree, with its shape, onto every
    tensor of the port's state_dict, and back bit for bit."""
    v = models['v']
    shapes = jax_variable_shapes(models['jm'])
    want = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(p): np.shape(leaf) for p, leaf in
           jax.tree_util.tree_flatten_with_path(v)[0]}
    assert got == want
    assert len(name_map(CFG)) == len(want)
    sd = flax_to_torch(v, CFG)
    assert set(sd) == {k for k in models['pm'].state_dict()
                       if not k.endswith('num_batches_tracked')}
    back = torch_to_flax(sd, CFG)
    for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_flax_initialisation():
    """``init_model`` gives what flax's initialisers give where they are
    fixed: zero offset and weight kernels, the grid-init offset biases of
    the JAX package's ``_grid_init_bias``, zero weight biases, identity
    LayerNorms; N(0, 1) embeddings and U[0, 1) row / col embeddings."""
    pm = init_model(BEVFormerDetector(CFG), torch.Generator().manual_seed(0))
    sd = pm.state_dict()
    head = 'pts_bbox_head.transformer.'
    grids = {'encoder.layers.0.tsa': np.tile(jax_att._grid_init_bias(8, 1, 4),
                                             2),
             'encoder.layers.0.sca.deformable_attention':
                 jax_att._grid_init_bias(8, 1, 8),
             'decoder.layers.1.cross_attn': jax_att._grid_init_bias(8, 1, 4)}
    for name, grid in grids.items():
        np.testing.assert_array_equal(
            sd[f'{head}{name}.sampling_offsets.bias'].numpy(), grid)
        for k in ('sampling_offsets.weight', 'attention_weights.weight',
                  'attention_weights.bias'):
            assert not sd[f'{head}{name}.{k}'].any()
    norms = [k for k in sd if '.norm' in k or ('cls_branches' in k and k
             .endswith(('.1.weight', '.1.bias', '.4.weight', '.4.bias')))]
    assert len(norms) == 2 * (3 * 3 + 2 * 2)
    for k in norms:
        assert (sd[k] == (1.0 if k.endswith('weight') else 0.0)).all(), k
    for k in ('bev_embedding', 'query_embedding', 'transformer.cams_embeds'):
        assert 0.8 < float(sd[f'pts_bbox_head.{k}'].std()) < 1.2
    row = sd['pts_bbox_head.positional_encoding.row_embed']
    assert float(row.min()) >= 0.0 and float(row.max()) < 1.0
