"""The Python side of the 3x3 conv kernels (``kernels/_conv3x3.py``), on
the CPU: the tiling the wrapper hands the kernel, the argument
checks, and the profiler's per-layer table.

``SERVING_LAYERS`` are the 36 convs of the serving configuration at b4
that the int8 tier sends to ``qconv``; ``test_serving_layers_table``
derives them again from the model on the meta device.
"""

import pytest
import torch

from omnihd_scenes_tpu_torch.kernels import _conv3x3
from omnihd_scenes_tpu_torch.kernels._conv3x3 import (TILE_SHAPES, block_n,
                                                       check_kernel_args,
                                                       raise_on_error,
                                                       tile_shape)

CL = torch.channels_last

# (layers, (N, C, H, W), Co) of the int8 tier's eligible convs at b4.
SERVING_LAYERS = [
    ('second.blocks.1.{1..5}.conv', (4, 128, 80, 120), 128, 5),
    ('second.blocks.2.{1..5}.conv', (4, 256, 40, 60), 256, 5),
    ('resnet.layer2.{1,2,3}.conv2', (24, 128, 68, 120), 128, 3),
    ('resnet.layer3.{1..5}.conv2', (24, 256, 34, 60), 256, 5),
    ('resnet.layer4.{1,2}.conv2', (24, 512, 17, 30), 512, 2),
    ('fpnc.fpn.fpn_convs.0', (24, 256, 68, 120), 256, 1),
    ('fpnc.fpn.fpn_convs.1', (24, 256, 34, 60), 256, 1),
    ('fpnc.fpn.fpn_convs.2', (24, 256, 17, 30), 256, 1),
    ('fpnc.reduce_conv', (24, 768, 136, 240), 256, 1),
    ('lss.depthnet.{reduce.conv, blocks.*.conv*}', (24, 256, 136, 240), 256,
     7),
    ('lss.bev_encoder.layers.0.conv', (4, 1024, 160, 240), 1024, 1),
    ('lss.bev_encoder.layers.1.conv', (4, 1024, 160, 240), 512, 1),
    ('lss.bev_encoder.layers.2.conv', (4, 512, 160, 240), 512, 1),
    ('lss.bev_encoder.layers.3.conv', (4, 512, 160, 240), 256, 1),
    ('fuse.conv', (4, 640, 160, 240), 384, 1),
]
SERVING_SHAPES = [(shape, co) for _, shape, co, _ in SERVING_LAYERS]
EDGE_SHAPES = [((4, 256, 1, 1), 256), ((2, 128, 7, 9), 128),
               ((1, 128, 6, 131), 256), ((2, 128, 9, 13), 136),
               ((2, 256, 17, 30), 256), ((1, 64, 3, 200), 8)]


def test_serving_layers_table():
    """The table above is what the serving model's eligible convs see."""
    from omnihd_scenes_tpu_torch.config import serving_config
    from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
    from omnihd_scenes_tpu_torch.models.quant import QConv2d, qconv_eligible

    cfg = serving_config()
    with torch.device('meta'):
        model = BEVFusion(cfg)
    seen = []
    for m in model.modules():
        if isinstance(m, QConv2d) and qconv_eligible(m):
            m.register_forward_hook(lambda mod, args, out: seen.append(
                (tuple(args[0].shape), mod.out_channels)))
    pc, lss = cfg.pillars, cfg.lss
    nx, ny, nz = lss.bev_nx
    with torch.no_grad():
        pts = model.second_fpn(model.second(
            torch.empty(4, pc.pfn_channels[-1], *pc.bev_hw, device='meta')))
        feat = model.fpnc(model.resnet(
            torch.empty(24, 3, *lss.final_dim, device='meta')))
        model.lss.depthnet(feat)
        cam = model.lss.bev_encoder(
            torch.empty(4, nz * lss.camC, ny, nx, device='meta'))
        model.fuse(torch.cat([cam, pts], 1))
    want = [(shape, co) for _, shape, co, count in SERVING_LAYERS
            for _ in range(count)]
    assert len(seen) == 36
    assert sorted(seen) == sorted(want)


def _waste(shape, tile):
    _, _, h, w = shape
    bh, bw = tile
    return -(-h // bh) * bh * -(-w // bw) * bw - h * w


@pytest.mark.parametrize('shape,co', SERVING_SHAPES + EDGE_SHAPES)
def test_tiles_cover_every_output_once(shape, co):
    """The launch geometry handed to the kernel: a 128-pixel rectangle of
    the kernel's set that wastes no more pixels than any other, and a
    channel tile the kernel is built for.  How the kernel walks its tiles
    is checked on the card, exactly, at these edge shapes
    (``tests/test_torch_port_gpu.py``)."""
    n, c, h, w = shape
    x = torch.empty(shape, dtype=torch.int8, memory_format=CL)
    wt = torch.empty((co, c, 3, 3), dtype=torch.int8, memory_format=CL)
    got = _conv3x3.launch_args(x, wt)
    bh, bw, bn = got[5:]
    assert got[:5] == (n, h, w, c, co)
    assert bh * bw == 128 and (bh, bw) in TILE_SHAPES
    assert _waste(shape, (bh, bw)) == min(_waste(shape, t)
                                          for t in TILE_SHAPES)
    assert bn == block_n(co) and bn in (128, 256)


@pytest.mark.parametrize('h,w,tile', [
    (136, 240, (8, 16)), (17, 30, (4, 32)), (1, 1, (8, 16)),
    (9, 13, (8, 16)), (30, 7, (16, 8)), (3, 200, (4, 32)),
    (2, 130, (2, 64))])
def test_tile_shape_picks(h, w, tile):
    assert tile_shape(h, w) == tile


@pytest.mark.parametrize('co,bn', [(256, 256), (512, 256), (1024, 256),
                                   (128, 128), (384, 128), (136, 128)])
def test_block_n(co, bn):
    assert block_n(co) == bn


def _cpu_args(shape, co, dtype):
    n, c, h, w = shape
    x = torch.empty((n, c, h, w), dtype=dtype, memory_format=CL)
    wt = torch.empty((co, c, 3, 3), dtype=dtype, memory_format=CL)
    return x, wt, torch.ones(co), torch.zeros(co)


@pytest.mark.parametrize('shape,co', SERVING_SHAPES)
def test_kernel_args_take_every_serving_layer(shape, co):
    check_kernel_args('qconv3x3', *_cpu_args(shape, co, torch.int8),
                      torch.int8)


@pytest.mark.parametrize('c,dtype', [(64, torch.int8), (192, torch.int8),
                                     (32, torch.bfloat16),
                                     (96, torch.bfloat16)])
def test_kernel_args_refuse_partial_swizzle_rows(c, dtype):
    """TMA's 128-byte swizzled box needs C * itemsize % 128 == 0."""
    with pytest.raises(ValueError, match='C \\* itemsize'):
        check_kernel_args('conv', *_cpu_args((1, c, 5, 6), 128, dtype),
                          dtype)


def test_kernel_args_refuse_the_rest():
    x, wt, scale, shift = _cpu_args((1, 128, 5, 6), 12, torch.int8)
    with pytest.raises(ValueError, match='Co % 8'):
        check_kernel_args('qconv3x3', x, wt, scale, shift, torch.int8)
    x, wt, scale, shift = _cpu_args((1, 128, 5, 6), 128, torch.int8)
    with pytest.raises(ValueError, match='channels_last'):
        check_kernel_args('qconv3x3', x.contiguous(), wt, scale, shift,
                          torch.int8)
    with pytest.raises(TypeError):
        check_kernel_args('qconv3x3', x, wt, scale, shift, torch.bfloat16)
    with pytest.raises(ValueError, match='non-empty'):
        check_kernel_args('qconv3x3', *_cpu_args((1, 128, 0, 6), 128,
                                                 torch.int8), torch.int8)


@pytest.mark.parametrize('err,words', [
    (0, None), (2, 'CUDA error 2'),
    (_conv3x3._ERR_NO_ENCODER, 'cuTensorMapEncodeTiled'),
    (_conv3x3._ERR_TILE, 'tile shape'),
    (_conv3x3._ERR_ENCODE + 1, 'CUresult 1')])
def test_launch_errors_raise(err, words):
    if words is None:
        raise_on_error('qconv3x3', err)
        return
    with pytest.raises(RuntimeError, match=words):
        raise_on_error('qconv3x3', err)


@pytest.mark.parametrize('ops,kind,nbytes,want', [
    (1979e9, 'int8', 1e6, (1.0, 'operations')),
    (989e9, 'bf16', 1e6, (1.0, 'operations')),
    (1e9, 'int8', 3.35e9, (1.0, 'bytes')),
    (0, 'bf16', 6.7e9, (2.0, 'bytes'))])
def test_roofline_bound(ops, kind, nbytes, want):
    from omnihd_scenes_tpu_torch.tools.roofline import bound

    ms, by = bound(ops, kind, nbytes)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-12)


def test_roofline_conv_cost():
    from omnihd_scenes_tpu_torch.tools.roofline import conv_cost

    ops, nbytes = conv_cost(2, 128, 5, 7, 256, 2, 4)
    assert ops == 2 * 9 * 128 * 256 * 70
    assert nbytes == 70 * 128 * 2 + 9 * 128 * 256 * 2 + 256 * 8 + 70 * 256 * 4


def test_profile_qconv_table():
    from omnihd_scenes_tpu_torch.tools.profile_components import qconv_table

    rows = [('a', (24, 256, 136, 240), 256, 2, 0.934),
            ('b', (24, 512, 17, 30), 512, 2, 0.1)]
    lines = qconv_table(rows)
    assert len(lines) == 4
    bound = 2 * 9 * 256 * 256 * 24 * 136 * 240 / 1979e12 * 1e3
    fields = lines[1].split(' | ')
    assert fields[2] == '8x16, 256'
    assert fields[4] == f'{bound:.4f} (operations)'
    assert fields[5] == f'{bound / 0.934:.3f}'
    assert lines[2].split(' | ')[2] == '4x32, 256'
    assert lines[3].startswith('sum of 2 launches')
