"""Evaluation suite: the devkit detection eval (mAP, TP errors, NOS) and
the semantic occupancy eval (IoU, mIoU)."""
