"""Device ms a call in the BEVFormer encoder
(``models/bevformer/encoder.py``: TSA and SCA), from CUDA events in
forward pre- and post-hooks on ``pts_bbox_head.transformer.encoder``."""


def attach(run):
    run.spans.module('encoder', run.driver.layers()['encoder'])


def read(run):
    return run.spans.total_ms('encoder') / run.window.requests
