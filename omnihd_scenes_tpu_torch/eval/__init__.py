"""Evaluation suite: the devkit detection eval (mAP, TP errors, NOS, the
PR / TP curve plots), the semantic occupancy eval (IoU, mIoU) and the
tracking eval (AMOTA / AMOTP and the MOT metrics)."""
