"""BEVFusion trained one step a call: the port's
``make_train_step(make_loss_fn_generic(...))`` with its AdamW (clip,
warm-up then cosine) over the model's f32 parameters, as ``tools.train``
runs the shipped configuration (f32; ``--bf16`` would wrap the loss in
``train/amp.py:bf16_policy``), on a pool of ready batches, cycled.

Set-up builds that one train state from the seed and drives it through
the first ``first_steps`` steps with the window's own call and feed, on
batches that all differ: those steps are the warm-up, and their readings
are what the comparison holds to the plain f32 reference
(``perfbench/reference/bevfusion.py`` and ``optim.py``), which follows
them from the same seeded weights and batches: each step's loss; the
first step's clipped gradient as the optimizer got it, worked out from
its first moment (``g = m / (1 - b1)``); the change of the parameters
over the steps.  The gradient and the change are compared by leaf, as a
gap of norms against the larger of that leaf's and the median leaf's
reference norm, the worst leaf counted; leaves whose reference gradient
is under a thousandth of the median leaf's are left out (they move by
round-off alone under Adam).
"""

from __future__ import annotations

import copy
import gc
import statistics

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import lowp, traffic
from perfbench.common import dataclass_of
from perfbench.reference import bevfusion as ref
from perfbench.reference import optim as ref_optim
from perfbench.weights import seeded_state_dict

B1 = ref_optim.B1
NEGLIGIBLE = 1e-3


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.train = cell.config['train']
        self.model_cfg = merged(cell.config['model'], self.train['model'])
        self.mix = cell.traffic
        self.control = self.train['control']
        self.marks = None
        self.readings = None
        self._flops = None

    # ---- the program --------------------------------------------------------

    def weights(self):
        with torch.device('meta'):
            layout = ref.build(self.model_cfg)
        return seeded_state_dict(layout, traffic.torch_seed(self.seed,
                                                            'weights'),
                                 self.device, torch.float32)

    def schedule_args(self):
        lc, opt = self.train['lr_config'], self.train['optimizer']
        return (opt['lr'], self.train['total_steps'], lc['warmup_iters'],
                lc['warmup_ratio'])

    def setup(self) -> None:
        from omnihd_scenes_tpu_torch.config import (BEVFusionConfig,
                                                    LSSConfig,
                                                    PointPillarsConfig)
        from omnihd_scenes_tpu_torch.models.bevfusion import BEVFusion
        from omnihd_scenes_tpu_torch.train.amp import bf16_policy
        from omnihd_scenes_tpu_torch.train.builder import (
            anchors_for, make_loss_fn_generic)
        from omnihd_scenes_tpu_torch.train.loop import (create_train_state,
                                                        make_train_step)
        from omnihd_scenes_tpu_torch.train.optim import (make_lr_schedule,
                                                         make_optimizer)
        from omnihd_scenes_tpu_torch.weights import load_state_dict
        allow = self.train['allow_tf32']
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        cfg = dataclass_of(BEVFusionConfig, self.model_cfg, lss=LSSConfig,
                           pillars=PointPillarsConfig)
        with torch.device(self.device):
            model = BEVFusion(cfg, self.train['point_dims'])
        load_state_dict(model, self.weights())
        lr, total, warmup, ratio = self.schedule_args()
        sched = make_lr_schedule(lr, total, self.train['lr_config']['policy'],
                                 warmup, ratio)
        opt = self.train['optimizer']
        state = create_train_state(model, lambda p: make_optimizer(
            p, sched, opt['weight_decay'], self.train['grad_clip_norm']))
        loss_fn = make_loss_fn_generic(
            model, 'bevfusion', anchors_for(model, 'bevfusion'),
            self.train['img_depth_loss_weight'],
            tuple(self.model_cfg['lss']['camera_depth_range']))
        if self.train['policy'] == 'bf16':
            loss_fn = bf16_policy(loss_fn)
        self.step = make_train_step(loss_fn, mark=self._mark)
        self.state = state
        self.model = model
        self.pool = traffic.train_pool(self.mix, self.model_cfg, self.seed,
                                       self.device)
        self.next_batch = 0
        self.readings = self.first_steps()

    def first_steps(self) -> dict:
        """Steps 1..n through the window's call; the program's readings."""
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        start = [p.detach().clone() for p in params]
        losses = []
        for k in range(self.mix['first_steps']):
            self.request(-1)
            losses.append(self.last_loss)
            if k == 0:
                grads = torch.stack([torch.linalg.vector_norm(m)
                                     for m in self.state.optimizer.mu])
                grads = grads / (1 - B1)
        deltas = torch.stack([torch.linalg.vector_norm(p.detach() - s)
                              for p, s in zip(params, start)])
        del start
        return {'losses': [float(x) for x in losses],
                'grads': dict(zip(names, grads.tolist())),
                'deltas': dict(zip(names, deltas.tolist()))}

    def _mark(self, stage: str) -> None:
        if self.marks is not None:
            self.marks.mark(stage)

    def request(self, i: int) -> int:
        self._mark('step_start')
        batch = self.pool[self.next_batch % len(self.pool)]
        self.next_batch += 1
        self.state, self.last_loss, _ = self.step(self.state, batch)
        return self.mix['batch']

    def layers(self) -> dict:
        return {'model': self.model}

    def release(self) -> None:
        self.state = self.model = self.step = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the reference ------------------------------------------------------

    def reference(self, control: str = None) -> torch.nn.Module:
        """The plain reference in f32 with the cell's weights, in train
        mode; with a ``control``, its convs and linears rounded to that
        precision."""
        model = ref.build(self.model_cfg)
        model.load_state_dict(self.weights())
        model.to(self.device).train()
        if control is not None:
            lowp.lower(model, control)
        return model

    def follow(self, model) -> dict:
        """``model`` trained through the first steps by the plain
        optimizer: the same readings as the program's."""
        named = list(model.named_parameters())
        names = [lowp.plain_name(n) for n, _ in named]
        params = [p for _, p in named]
        lr, total, warmup, ratio = self.schedule_args()
        opt = ref_optim.AdamW(
            params, ref_optim.warmup_cosine(lr, total, warmup, ratio),
            self.train['optimizer']['weight_decay'],
            self.train['grad_clip_norm'])
        anchors = torch.from_numpy(ref.anchors(
            self.model_cfg['pillars'])).to(self.device)
        start = [p.detach().clone() for p in params]
        losses = []
        for k in range(self.mix['first_steps']):
            b = {key: torch.from_numpy(v).to(self.device)
                 for key, v in self.pool[k].items()}
            out = model(b['points'], b['points_mask'], b['imgs'],
                        b['img2lidar_rots'], b['img2lidar_trans'])
            loss, _ = ref.detection_loss(
                out, b, anchors, self.train['img_depth_loss_weight'],
                self.model_cfg['lss']['camera_depth_range'])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            del out
            clipped = opt.step(grads)
            if k == 0:
                first = [float(torch.linalg.vector_norm(g)) for g in clipped]
            losses.append(float(loss.detach()))
        deltas = [float(torch.linalg.vector_norm(p.detach() - s))
                  for p, s in zip(params, start)]
        return {'losses': losses, 'grads': dict(zip(names, first)),
                'deltas': dict(zip(names, deltas))}

    def picks(self) -> None:
        return None

    def answers(self, model, picks) -> dict:
        """``model`` (a reference) in the program's place."""
        return self.follow(model)

    def compare(self, readings: dict, model) -> dict:
        r = self.follow(model)
        med_g = statistics.median(r['grads'].values())
        kept = [n for n, g in r['grads'].items() if g >= NEGLIGIBLE * med_g]

        def gap(key):
            med = statistics.median(r[key][n] for n in kept)
            return max(abs(readings[key][n] - r[key][n]) / max(r[key][n], med)
                       for n in kept)
        return {
            'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(
                readings['losses'], r['losses'])),
            'grad_norm_gap': gap('grads'),
            'update_norm_gap': gap('deltas'),
        }

    def check(self) -> dict:
        with lowp.no_tf32():
            return self.compare(self.readings, self.reference())

    def flops_per_sample(self) -> float:
        """FLOPs of the reference's forward and backward on one sample at
        the cell's shapes, counted on the meta device."""
        if self._flops is None:
            with torch.device('meta'):
                model = ref.build(self.model_cfg).train()
                b = {k: torch.empty(v.shape, dtype=torch.from_numpy(
                    v[:0]).dtype) for k, v in self.pool[0].items()}
                anchors = torch.empty(*ref.head_hw(self.model_cfg['pillars']),
                                      8, 9)
            with FlopCounterMode(display=False) as counter:
                out = model(b['points'], b['points_mask'], b['imgs'],
                            b['img2lidar_rots'], b['img2lidar_trans'])
                loss = sum(out[k].float().sum() for k in (
                    'cls_score', 'bbox_pred', 'dir_pred', 'depth'))
                loss.backward()
            self._flops = counter.get_total_flops() / self.mix['batch']
        return self._flops
