"""Device ms a call in the LSS camera trunk (``models/lss.py:DepthNet``
with ASPP), from CUDA events in forward pre- and post-hooks on
``lss.depthnet``."""


def attach(run):
    run.spans.module('depthnet', run.driver.layers()['depthnet'])


def read(run):
    return run.spans.total_ms('depthnet') / run.window.requests
