"""BEVFormer-T (counterpart of ``omnihd_scenes_tpu/models/bevformer``)."""

from omnihd_scenes_tpu_torch.models.bevformer.detector import (
    BEVFormerDetector, init_bevformer, sca_overflow_for_rig)

__all__ = ['BEVFormerDetector', 'init_bevformer', 'sca_overflow_for_rig']
