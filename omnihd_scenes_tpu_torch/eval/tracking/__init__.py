"""Tracking eval (AMOTA / AMOTP and the legacy MOT metrics), the
counterpart of ``omnihd_scenes_tpu/eval/tracking/``."""

from omnihd_scenes_tpu_torch.eval.tracking.data_classes import (TrackingBox,
                                                                TrackingConfig)
from omnihd_scenes_tpu_torch.eval.tracking.evaluate import TrackingEval

__all__ = ['TrackingEval', 'TrackingBox', 'TrackingConfig']
