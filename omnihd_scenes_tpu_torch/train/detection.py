"""Detection experiment assembly (counterpart of
``omnihd_scenes_tpu/train/detection.py``): config -> datasets, the
PointPillars loss and predict functions, batched inference.

``make_loss_fn`` / ``make_predict_fn`` are the pillar family's entries of
:mod:`omnihd_scenes_tpu_torch.train.builder`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from omnihd_scenes_tpu_torch.config import DecodeCfg
from omnihd_scenes_tpu_torch.data.dataset import NewScenesDetDataset
from omnihd_scenes_tpu_torch.data.temporal_dataset import (
    TemporalNewScenesDataset)
from omnihd_scenes_tpu_torch.train.builder import (make_loss_fn_generic,
                                                   make_predict_fn_generic)
from omnihd_scenes_tpu_torch.train.eval_runner import run_inference_generic


def build_dataset_single(ds_cfg, dataset_type: str = 'det',
                         image_decode: str = 'host'):
    """The dataset of one split's config; ``image_decode='device'`` leaves
    the camera pixels to ``image_loading.decode_camera_batch``."""
    kwargs = ds_cfg.to_dict() if hasattr(ds_cfg, 'to_dict') else dict(ds_cfg)
    kwargs.pop('wrapper', None)    # consumed by the caller (sampling.wrap_dataset)
    kwargs['image_decode'] = image_decode
    if dataset_type == 'temporal':
        return TemporalNewScenesDataset(**kwargs)
    return NewScenesDetDataset(**kwargs)


def build_datasets(cfg, image_decode: str = 'host'):
    """The train and val datasets of a config, both with
    ``image_decode``."""
    dtype = cfg.get('dataset_type', 'det')
    train_ds = build_dataset_single(cfg.data.train, dtype, image_decode)
    val_ds = build_dataset_single(cfg.data.val, dtype, image_decode)
    return train_ds, val_ds


def make_loss_fn(model):
    """``loss_fn(model, params, batch) -> (loss, aux)`` of a PointPillars
    model."""
    return make_loss_fn_generic(model, 'pointpillars', model.cfg.anchors())


def make_predict_fn(model, decode_cfg: Optional[DecodeCfg] = None):
    """``predict(model, batch) -> ((boxes, scores, labels, valid), None)``
    of a PointPillars model."""
    return make_predict_fn_generic(model, 'pointpillars', model.cfg.anchors(),
                                   decode_cfg)


def run_inference(predict_fn, model, dataset, batch_size: int) -> List[Dict]:
    """Batched inference -> per-sample result dicts in dataset order."""
    return run_inference_generic(predict_fn, model, dataset,
                                 batch_size)['bbox_results']
