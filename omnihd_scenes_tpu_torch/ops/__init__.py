"""Tensor operations of the serving path: LSS index fields, 3D boxes,
rotated NMS; and the chamfer distance of the occupancy eval."""

from omnihd_scenes_tpu_torch.ops.nms import (multiclass_nms_rotated,
                                             nms_rotated)

__all__ = ['multiclass_nms_rotated', 'nms_rotated']
