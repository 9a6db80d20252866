"""BEVFusion served in batches: each call is one ``Predictor.__call__``
of the port (upload, the network, decode, rotated NMS) on a request of
the traffic mix's pool, cycled.

Correctness: the head's outputs of the timed calls (a forward hook on
the predictor's model) and their detections, for a seeded sample of the
window's calls, against the plain f32 reference of
``perfbench/reference/bevfusion.py`` run on the same inputs with the same
seeded weights: the head maps, DepthNet's depth distributions and the
fused BEV as relative errors; the decode and NMS by running the
reference's decode on the program's own head outputs, which has to give
the served detections slot for slot.
"""

from __future__ import annotations

import gc
from collections import defaultdict

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import lowp, traffic
from perfbench.common import Reservoir, dataclass_of, dets_mismatch, rel_err
from perfbench.reference import bevfusion as ref
from perfbench.weights import seeded_state_dict

HEAD_MAPS = ('cls_score', 'bbox_pred', 'dir_pred')


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.model_cfg = cell.config['model']
        self.dtype = getattr(torch, cell.config['dtype'])
        self.decode = ref.DecodeCfg(**cell.config['decode'])
        self.mix = cell.traffic
        self.control = cell.config['control']
        self.kept = Reservoir(self.mix['checked'],
                              traffic.substream(seed, 'checked'))
        self.in_window = False
        self._out = None
        self._flops = None

    # ---- the program --------------------------------------------------------

    def weights(self):
        with torch.device('meta'):
            layout = ref.build(self.model_cfg)
        return seeded_state_dict(layout, traffic.torch_seed(self.seed,
                                                            'weights'),
                                 self.device, self.dtype)

    def setup(self) -> None:
        from omnihd_scenes_tpu_torch.config import (BEVFusionConfig,
                                                    DecodeCfg, LSSConfig,
                                                    PointPillarsConfig)
        from omnihd_scenes_tpu_torch.serve.predictor import Predictor
        allow = self.cell.config['allow_tf32']
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        cfg = dataclass_of(BEVFusionConfig, self.model_cfg, lss=LSSConfig,
                           pillars=PointPillarsConfig)
        self.predictor = Predictor(cfg, self.weights(), self.device,
                                   self.dtype,
                                   DecodeCfg(**self.cell.config['decode']))
        self.predictor.model.register_forward_hook(self._hook)
        self.pool = traffic.serve_pool(self.mix, self.model_cfg, self.seed,
                                       self.device)
        for i in range(self.mix['warmup']):
            self.request(i)
        self.in_window = True

    def _hook(self, module, args, out):
        self._out = out

    def request(self, i: int) -> int:
        dets = self.predictor(*self.pool[i % len(self.pool)])
        if self.in_window:
            self.kept.offer((i, self._out, dets))
        self._out = None
        return self.mix['batch']

    def layers(self) -> dict:
        model = self.predictor.model
        return {'model': model, 'resnet': model.resnet,
                'depthnet': model.lss.depthnet}

    def release(self) -> None:
        self.predictor = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the reference ------------------------------------------------------

    def reference(self, control: str = None) -> torch.nn.Module:
        """The plain reference in f32 with the cell's weights; with a
        ``control`` (``'fp8'``, ``'tf32'``), its convs and linears rounded
        to that precision."""
        model = ref.build(self.model_cfg)
        state = {k: v.float() if v.is_floating_point() else v
                 for k, v in self.weights().items()}
        model.load_state_dict(state)
        model.to(self.device).eval()
        if control is not None:
            lowp.lower(model, control)
        return model

    def inputs(self, i: int):
        points, mask, imgs, rots, trans = self.pool[i % len(self.pool)]
        return [torch.from_numpy(x).to(self.device)
                for x in (points, mask, imgs, rots, trans)]

    def answers(self, model: torch.nn.Module, calls):
        """``model`` (a reference) in the program's place: (call, outputs,
        detections) of each call."""
        anchors = torch.from_numpy(ref.anchors(
            self.model_cfg['pillars'])).to(self.device)
        out = []
        with torch.no_grad():
            for i in calls:
                o = model(*self.inputs(i))
                out.append((i, o, ref.anchor_head_get_bboxes(
                    *(o[k].float() for k in HEAD_MAPS), anchors,
                    self.decode)))
        return out

    def compare(self, answers, model: torch.nn.Module) -> dict:
        """The worst of each number over ``answers`` against the f32
        reference ``model``."""
        anchors = torch.from_numpy(ref.anchors(
            self.model_cfg['pillars'])).to(self.device)
        worst = defaultdict(float)
        with torch.no_grad():
            for i, out, dets in answers:
                r = model(*self.inputs(i))
                numbers = {
                    'head_rel_err': max(rel_err(out[k].float(), r[k])
                                        for k in HEAD_MAPS),
                    'depth_rel_err': rel_err(out['depth'].float(),
                                             r['depth']),
                    'bev_rel_err': rel_err(out['bev'].float(), r['bev']),
                    'decode_mismatch': dets_mismatch(
                        dets, ref.anchor_head_get_bboxes(
                            *(out[k].float() for k in HEAD_MAPS), anchors,
                            self.decode)),
                }
                for k, v in numbers.items():
                    worst[k] = max(worst[k], v)
                del r
        return dict(worst)

    def picks(self) -> list:
        """The window's calls that the comparison samples."""
        return [item[0] for item in self.kept.items]

    def check(self) -> dict:
        with lowp.no_tf32():
            return self.compare(self.kept.items, self.reference())

    def flops_per_sample(self) -> float:
        """FLOPs of the reference's forward on one sample at the cell's
        shapes, counted on the meta device."""
        if self._flops is None:
            b = self.mix['batch']
            with torch.device('meta'):
                model = ref.build(self.model_cfg)
                args = [torch.empty(x.shape, dtype=torch.from_numpy(
                    x[:0]).dtype) for x in self.pool[0]]
            with FlopCounterMode(display=False) as counter:
                model(*args)
            self._flops = counter.get_total_flops() / b
        return self._flops
