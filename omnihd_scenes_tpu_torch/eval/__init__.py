"""Evaluation suite: the devkit detection eval (mAP, TP errors, NOS)."""
