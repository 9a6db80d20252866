"""Dataset SDK: database, boxes, geometry, converter, synthetic data."""

from omnihd_scenes_tpu_torch.devkit.boxes import Box
from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.devkit.geometry import (BoxVisibility, box_in_image,
                                               points_in_box, transform_matrix,
                                               transform_points, view_points)

__all__ = ['Box', 'NewScenes', 'BoxVisibility', 'box_in_image',
           'points_in_box', 'transform_matrix', 'transform_points',
           'view_points']
