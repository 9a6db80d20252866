"""AOT model export for deployment (counterpart of
``omnihd_scenes_tpu/serve/export.py``, the TensorRT-engine analogue).

JAX lowers its jitted inference function to a serialized StableHLO
artifact; here :func:`torch.export.export` traces the same function into
an ``ExportedProgram``, loadable and runnable without any model code: only
the bundle, torch and the port's kernels, whose LSS view transform is the
registered op ``omnihd::lss_sample_bev`` (``kernels/lss_sample.py``; the
hand kernel on the card, its plain version on the CPU).

A bundle is a directory:

    exported.pt2   ``torch.export.save`` of the program, which takes the
                   weights as its first input and holds none (JAX's
                   params-as-inputs), so it is small and a bundle whose
                   ``weights.pt`` is replaced serves the new weights
    weights.pt     that input: the served model's state dict (weights,
                   buffers, the anchors), loaded by :func:`load_exported`
    meta.json      model type, precision, torch version, device, input
                   names, shapes and dtypes, the decode's nms_pre and max_num

The exported function is JAX's ``infer``: the network, then
``anchor_head_get_bboxes`` in f32 (decode and the rotated NMS), and for
BEVFusion-OCC the occupancy argmax after the boxes.  BEVFormer-T has no
anchors, and JAX's ``infer`` then returns the network's outputs as they
are: the queue forward (``BEVFormerDetector.forward``, inputs
``imgs_queue``, ``can_bus_queue``, ``lidar2img_queue``,
``has_prev_queue``) and its dict of ``bev_embed``, ``all_cls_scores``
and ``all_bbox_preds``, undecoded (meta ``decode`` None, with the queue
length and the SCA query cap; the bundle drops what the cap drops, as
JAX's does).  JAX's docstring names ``forward_stream`` but its code
exports the queue forward, which is what is ported.  Precision follows
``Predictor`` and ``predict_stream`` (ROADMAP queue 3 items 1 and 21):
with ``bf16`` the weights and the images are bf16 and points, geometry,
CAN bus and anchors stay f32 (the masks bool), where JAX's ``_to_bf16``
casts every f32 input.  A fused checkpoint's passthrough BNs are folded
first, as ``Predictor`` folds them (``serve/fuse.py``; a BEVFormer's
traced on the example queue).  The program is traced for one device;
JAX's ``--platforms`` (lowering for several backends at once) has no
counterpart, and :func:`load_exported` moves a program to another device
when asked.  Not ported: the int8 tier (JAX's ``export_model`` drops the
``quant`` collection too).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

# Registers omnihd::lss_sample_bev, which a loaded program calls.
from omnihd_scenes_tpu_torch.kernels import lss_sample  # noqa: F401
from omnihd_scenes_tpu_torch.serve.inputs import (BEVFORMER_INPUTS,
                                                  CAMERA_INPUTS,
                                                  PILLAR_INPUTS, upload)

PROGRAM, WEIGHTS, META = 'exported.pt2', 'weights.pt', 'meta.json'


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


class ExportedModel:
    """A loaded bundle: ``__call__(*inputs)`` runs inference and returns
    the decoded boxes (a tuple), or a BEVFormer's outputs (a dict).
    Inputs are NumPy arrays or tensors (None where the model has no such
    stream), cast and uploaded by ``Predictor``'s rules
    (``serve/inputs.py``), the camera rotations checked on the host
    first.
    ``program`` is the loaded ``ExportedProgram``, ``weights`` its first
    input (``weights.pt`` on the device)."""

    def __init__(self, program, weights: Dict[str, torch.Tensor],
                 meta: Dict[str, Any], device: torch.device):
        self.program = program
        self.weights = weights
        self.meta = meta
        self.device = device
        self.dtype = torch.bfloat16 if meta['bf16'] else torch.float32
        self._module = program.module()

    @property
    def input_specs(self):
        return self.meta['inputs']

    def __call__(self, *inputs):
        if len(inputs) != len(self.input_specs):
            raise TypeError(f'{len(self.input_specs)} inputs '
                            f'{[s["name"] for s in self.input_specs]}, got '
                            f'{len(inputs)}')
        # An input the program was exported without stays None.
        args = upload([s['name'] for s in self.input_specs],
                      [None if s['dtype'] is None else x
                       for s, x in zip(self.input_specs, inputs)],
                      self.device, self.dtype)
        with torch.inference_mode():
            return self._module(self.weights, *args)


class _Served(torch.nn.Module):
    """The exported function: network, then decode + rotated NMS in f32
    (and the occupancy argmax), as ``Predictor.__call__``."""

    def __init__(self, model, anchors: torch.Tensor, decode_cfg):
        super().__init__()
        self.model = model
        self.register_buffer('anchors', anchors)
        self.decode_cfg = decode_cfg

    def forward(self, *inputs):
        from omnihd_scenes_tpu_torch.models.anchor_head import (
            anchor_head_get_bboxes)

        out = self.model(*inputs)
        dets = anchor_head_get_bboxes(
            out['cls_score'].float(), out['bbox_pred'].float(),
            out['dir_pred'].float(), self.anchors, self.decode_cfg)
        if out.get('occ_logits') is not None:
            return (*dets, out['occ_logits'].argmax(-1))
        return dets


class _Raw(torch.nn.Module):
    """The exported function of a model without anchors (BEVFormer-T):
    the network's outputs as they are, as JAX's ``infer`` returns them."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *inputs):
        return self.model(*inputs)


class _Program(torch.nn.Module):
    """``forward(state, *inputs)``: the served module run on ``state`` (its
    state dict), which it does not hold (kept out of its submodules), so
    the exported program has no weights of its own."""

    def __init__(self, served: _Served):
        super().__init__()
        self._served = (served,)

    def forward(self, state, *inputs):
        return functional_call(self._served[0], state, inputs)


def export_model(model: torch.nn.Module, mtype: str,
                 state_dict: Mapping[str, torch.Tensor], example_inputs,
                 out_dir: str, *, anchors: Optional[np.ndarray] = None,
                 bf16: bool = True, device='cuda', decode_cfg=None) -> str:
    """Export ``model`` (an anchor-family detector or a BEVFormer-T, on
    the host) with ``state_dict`` as a bundle in ``out_dir`` (created).

    ``example_inputs``: the model's positional inputs (points,
    points_mask[, imgs, rots, trans]; a BEVFormer's queue, imgs_queue,
    can_bus_queue, lidar2img_queue, has_prev_queue), NumPy arrays,
    tensors or None, or a batch dict (``train.builder.model_inputs``);
    they fix the shapes, and a fused checkpoint's passthroughs are traced
    on them.  ``anchors``: the dense anchor grid
    (``train.builder.anchors_for``; None for BEVFormer).  ``bf16``: the
    deployment precision (bf16 weights and images).  Returns ``out_dir``;
    ``meta.json`` records the export's seconds."""
    from omnihd_scenes_tpu_torch.config import DecodeCfg
    from omnihd_scenes_tpu_torch.serve.predictor import serving_model
    from omnihd_scenes_tpu_torch.train.builder import (ANCHOR_FAMILIES,
                                                       PILLAR_FAMILIES,
                                                       model_inputs)
    from omnihd_scenes_tpu_torch.weights import load_state_dict

    raw = mtype == 'bevformer'
    if raw != (anchors is None) or (not raw and mtype not in ANCHOR_FAMILIES):
        raise ValueError(f'export covers the anchor families with their '
                         f'anchors and BEVFormer without, not {mtype!r} '
                         f'with anchors {anchors is not None}')
    device = _device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    decode_cfg = decode_cfg or DecodeCfg()
    if isinstance(example_inputs, Mapping):
        example_inputs = model_inputs(example_inputs, mtype)
    names = (BEVFORMER_INPUTS if raw else PILLAR_INPUTS
             if mtype in PILLAR_FAMILIES else CAMERA_INPUTS)
    if len(example_inputs) != len(names):
        raise ValueError(f'{mtype} takes {names}, got {len(example_inputs)} '
                         f'inputs')
    load_state_dict(model, state_dict)
    model = serving_model(model, device, dtype, lambda: example_inputs)
    if raw:
        served = _Raw(model).eval()
    else:
        served = _Served(model, torch.from_numpy(np.asarray(
            anchors, np.float32)).to(device), decode_cfg).eval()
    args = tuple(upload(names, example_inputs, device, dtype))
    # JAX's params-as-inputs: the program takes the served module's state
    # (weights, buffers, anchors) as its first input and holds none.
    state = {k: v.detach() for k, v in served.state_dict().items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Program(served), (state, *args))
    seconds = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    program.example_inputs = None       # the weights and a whole request
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    torch.save({k: v.cpu() for k, v in state.items()},
               os.path.join(out_dir, WEIGHTS))
    meta = {
        'mtype': mtype, 'bf16': bool(bf16),
        'torch_version': torch.__version__,
        'device': str(device),
        'device_name': (torch.cuda.get_device_name(device)
                        if device.type == 'cuda' else 'cpu'),
        'inputs': [{'name': n,
                    'shape': None if a is None else list(a.shape),
                    'dtype': (None if a is None
                              else str(a.dtype).split('.')[-1])}
                   for n, a in zip(names, args)],
        'decode': None if raw else {'nms_pre': decode_cfg.nms_pre,
                                    'max_num': decode_cfg.max_num},
        'export_seconds': seconds,
    }
    if raw:
        meta['queue_length'] = int(model.cfg.queue_length)
        meta['sca_query_cap'] = float(model.cfg.sca_query_cap)
    with open(os.path.join(out_dir, META), 'w') as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_exported(bundle_dir: str, device='cuda') -> ExportedModel:
    """Load a bundle of :func:`export_model` onto ``device`` (moved there
    if it was exported for another), with the weights of ``weights.pt``.
    Imports no model code."""
    device = _device(device)
    with open(os.path.join(bundle_dir, META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(bundle_dir, PROGRAM))
    if torch.device(meta['device']) != device:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    weights = torch.load(os.path.join(bundle_dir, WEIGHTS),
                         map_location=device, weights_only=True)
    return ExportedModel(program, weights, meta, device)
