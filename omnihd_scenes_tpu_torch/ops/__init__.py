"""Tensor operations of the serving path: LSS index fields, 3D boxes,
rotated NMS; and the chamfer distance of the occupancy eval."""
