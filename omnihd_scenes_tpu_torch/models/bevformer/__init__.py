"""BEVFormer-T (counterpart of ``omnihd_scenes_tpu/models/bevformer``)."""

from omnihd_scenes_tpu_torch.models.bevformer.detector import (
    BEVFormerDetector, GridMaskDraws, grid_mask, grid_mask_draws,
    init_bevformer, sca_overflow_for_rig)
from omnihd_scenes_tpu_torch.models.bevformer.loss import (
    DETRLossCfg, bevformer_head_loss)

__all__ = ['BEVFormerDetector', 'DETRLossCfg', 'GridMaskDraws',
           'bevformer_head_loss', 'grid_mask', 'grid_mask_draws',
           'init_bevformer', 'sca_overflow_for_rig']
