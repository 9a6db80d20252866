"""BEVFormer-T serving independent streams: each call is one
``StreamPredictor.__call__`` of the port on one frame of every stream,
each stream's returned ``bev_embed`` carried into its next call.

Correctness: for a seeded sample of the window's calls, every stream's
BEV the call returned to be carried, the last decoder layer's class
logits and box codes (a forward hook on the head) and the served
detections, against the plain f32 reference of
``perfbench/reference/bevformer_t.py`` replaying the streams, batched,
from the call where the oldest of their current scenes began (a stream
is reset on its scene's first frame, so an earlier start changes
nothing) with the same seeded weights and inputs; the decode by running
the reference's decode on the program's own last-layer outputs, which
has to give the served detections slot for slot.
"""

from __future__ import annotations

import gc
from collections import defaultdict

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import lowp, traffic
from perfbench.common import (Reservoir, dataclass_of, dets_mismatch,
                              rel_err, tuples)
from perfbench.reference import bevformer_t as ref
from perfbench.weights import seeded_state_dict


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.model_cfg = cell.config['model']
        self.dtype = getattr(torch, cell.config['dtype'])
        self.decoder = ref.NMSFreeCoderCfg(**cell.config['decode'])
        self.mix = cell.traffic
        self.control = cell.config['control']
        self.kept = Reservoir(self.mix['checked'],
                              traffic.substream(seed, 'checked'))
        self.in_window = False
        self.next_call = 0
        self._out = None
        self._flops = None

    # ---- the program --------------------------------------------------------

    def weights(self):
        with torch.device('meta'):
            layout = ref.build(self.model_cfg)
        return seeded_state_dict(layout, traffic.torch_seed(self.seed,
                                                            'weights'),
                                 self.device, self.dtype,
                                 self.cell.config['offset_std'])

    def setup(self) -> None:
        from omnihd_scenes_tpu_torch.config import BEVFormerConfig
        from omnihd_scenes_tpu_torch.models.bbox_coder import \
            NMSFreeCoderCfg
        from omnihd_scenes_tpu_torch.serve.predictor import StreamPredictor
        allow = self.cell.config['allow_tf32']
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        self.predictor = StreamPredictor(
            dataclass_of(BEVFormerConfig, self.model_cfg), self.weights(),
            self.device, self.dtype,
            NMSFreeCoderCfg(**tuples(self.cell.config['decode'])))
        self.predictor.model.pts_bbox_head.register_forward_hook(self._hook)
        self.plan = traffic.StreamPlan(self.mix, self.model_cfg, self.seed,
                                       self.device)
        self.bev = self.predictor.zero_bev(self.mix['streams'])
        for _ in range(self.mix['warmup']):
            self.request(-1)
        self.in_window = True

    def _hook(self, module, args, out):
        self._out = out

    def request(self, i: int) -> int:
        c = self.next_call
        self.next_call += 1
        imgs, can_bus, l2i, has_prev = self.plan.call(c)
        dets, self.bev = self.predictor(imgs, can_bus, l2i, self.bev,
                                        has_prev)
        if self.in_window:
            out = self._out
            self.kept.offer((c, {'bev_embed': self.bev,
                                 'cls': out['all_cls_scores'][:, -1],
                                 'box': out['all_bbox_preds'][:, -1]},
                             dets))
        self._out = None
        return self.mix['streams']

    def layers(self) -> dict:
        model = self.predictor.model
        return {'model': model, 'resnet': model.img_backbone,
                'encoder': model.pts_bbox_head.transformer.encoder}

    def release(self) -> None:
        self.predictor = self.bev = None
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

    def replay(self, model, c: int) -> dict:
        """``model``'s outputs for every stream at call ``c``, replayed
        from the first frame of the oldest current scene (or call 0)."""
        plan, dev = self.plan, self.device
        cfg = self.model_cfg
        prev = torch.zeros(plan.streams, cfg['bev_h'] * cfg['bev_w'],
                           cfg['embed_dims'], device=dev)
        l2i = torch.from_numpy(plan.lidar2img).to(dev)
        with torch.no_grad():
            for k in range(max(0, c - plan.scene + 1), c + 1):
                imgs, can, _, has_prev = plan.call(k)
                out = model.forward_stream(
                    torch.from_numpy(imgs).to(dev),
                    torch.from_numpy(can).to(dev), l2i, prev,
                    torch.from_numpy(has_prev).to(dev))
                prev = out['bev_embed']
        return {'bev_embed': out['bev_embed'],
                'cls': out['all_cls_scores'][:, -1],
                'box': out['all_bbox_preds'][:, -1]}

    def decode(self, out: dict):
        return ref.nms_free_decode(out['cls'].float(), out['box'].float(),
                                   self.decoder)

    def answers(self, model, calls):
        """``model`` (a reference) in the program's place at each call."""
        out = []
        for c in calls:
            o = self.replay(model, c)
            out.append((c, o, self.decode(o)))
        return out

    def compare(self, answers, model) -> dict:
        worst = defaultdict(float)
        for c, out, dets in answers:
            r = self.replay(model, c)
            numbers = {
                'bev_rel_err': rel_err(out['bev_embed'].float(),
                                       r['bev_embed']),
                'cls_rel_err': rel_err(out['cls'].float(), r['cls']),
                'box_rel_err': rel_err(out['box'].float(), r['box']),
                'decode_mismatch': dets_mismatch(dets, self.decode(out)),
            }
            for k, v in numbers.items():
                worst[k] = max(worst[k], v)
        return dict(worst)

    def picks(self) -> list:
        """The window's calls that the comparison samples."""
        return [item[0] for item in self.kept.items]

    def check(self) -> dict:
        with lowp.no_tf32():
            return self.compare(self.kept.items, self.reference())

    def flops_per_sample(self) -> float:
        """FLOPs of the reference's forward on one stream's frame,
        counted on the meta device at the cell's shapes."""
        if self._flops is None:
            cfg, b = self.model_cfg, self.mix['streams']
            h, w = cfg['img_hw']
            with torch.device('meta'):
                model = ref.build(cfg)
                args = (torch.empty(b, cfg['num_cams'], h, w, 3),
                        torch.empty(b, 18),
                        torch.empty(b, cfg['num_cams'], 4, 4),
                        torch.empty(b, cfg['bev_h'] * cfg['bev_w'],
                                    cfg['embed_dims']),
                        torch.ones(b, dtype=torch.bool))
            with FlopCounterMode(display=False) as counter:
                model.forward_stream(*args)
            self._flops = counter.get_total_flops() / b
        return self._flops

