"""Which inputs the bf16 serving tier casts (ROADMAP queue 3, fault 1).

The port's ``Predictor`` runs the network in bf16 but keeps the radar
points, the camera rotations / translations and the anchors in f32; the
JAX package's own inference (``tools/test.py`` through
``train/builder.py:make_predict_fn_generic``) casts none of them either.
Only the root ``bench.py:547-560`` casts all of them to bf16 before the
f32 decode.  This test serves the mini BEVFusion (dense pillars, the
sampling splat) in bf16 on the CPU twice on the same weights and batch:
as the port serves it, and with those inputs rounded to bf16 as the bench
does, and pins the gap between the two against the gap bf16 itself opens
to the f32 network.
"""

import pytest
import torch

from chip_smoke import box_match
from omnihd_scenes_tpu_torch.models.anchor_head import anchor_head_get_bboxes
from omnihd_scenes_tpu_torch.serve.predictor import Predictor
from omnihd_scenes_tpu_torch.weights import flax_to_torch
from tests.test_torch_port_bevfusion import _batch2
from tests.test_torch_port_weights import PORT_MINI_CFG, mini_variables

torch.set_num_threads(1)


def _float(dets):
    return [t.float() if t.is_floating_point() else t for t in dets]


def _bf16_rounded(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


@pytest.fixture(scope='module')
def served():
    sd = flax_to_torch(mini_variables(), PORT_MINI_CFG)
    pts, mask, imgs, rots, trans = _batch2()
    bf16 = Predictor(PORT_MINI_CFG, sd, device='cpu', dtype=torch.bfloat16)
    f32 = Predictor(PORT_MINI_CFG, sd, device='cpu', dtype=torch.float32)
    port = _float(bf16(pts, mask, imgs, rots, trans))
    ref = _float(f32(pts, mask, imgs, rots, trans))
    out = bf16.forward(_bf16_rounded(pts), mask, imgs, _bf16_rounded(rots),
                       _bf16_rounded(trans))
    bench = _float(anchor_head_get_bboxes(
        out['cls_score'].float(), out['bbox_pred'].float(),
        out['dir_pred'].float(), bf16.anchors.to(torch.bfloat16).float(),
        bf16.decode_cfg))
    return port, bench, ref


def _gap(a, b):
    """(share of a's kept boxes matching a kept box of b, largest score
    difference of a kept box to its best-overlapping same-label box of
    b)."""
    boxes, scores, labels, valid = a
    match = box_match(boxes, labels, valid, b[0], b[2], b[3])
    from omnihd_scenes_tpu_torch.ops.boxes3d import rotated_iou_bev

    iou = rotated_iou_bev(boxes, b[0])
    iou = torch.where((labels[..., :, None] == b[2][..., None, :])
                      & b[3][..., None, :], iou, -1.0)
    nearest = torch.gather(b[1], -1, iou.argmax(-1))
    score = float(((scores - nearest).abs() * valid).max())
    return match, score


def test_bench_casts_move_the_boxes_less_than_bf16_does(served):
    port, bench, ref = served
    assert int(port[3].sum()) > 20
    cast_match, cast_score = _gap(bench, port)
    bf16_match, bf16_score = _gap(port, ref)
    print(f'bench casts vs port: {cast_match:.4f} of boxes matched, '
          f'scores within {cast_score:.4e}; bf16 vs f32: {bf16_match:.4f}, '
          f'{bf16_score:.4e}')
    # Pinned from the CPU run (ROADMAP.md, queue 3; it read 0.9537 and
    # 2.10e-2 for the casts, 0.9326 and 1.10e-2 for bf16 against f32): the
    # casts leave nearly every kept box in place and move scores by about
    # twice what the bf16 network itself does.
    assert cast_match >= 0.9 and bf16_match >= 0.9
    assert cast_score <= 4e-2 and bf16_score <= 2e-2


def test_the_casts_change_the_result(served):
    """The two forms are not the same computation: rounding the geometry
    and points moves the outputs."""
    port, bench, _ = served
    assert not (torch.equal(port[0], bench[0])
                and torch.equal(port[1], bench[1]))
