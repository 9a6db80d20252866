"""Device ms a call in the camera backbone (``models/resnet.py:ResNet``),
from CUDA events in forward pre- and post-hooks on the model's ResNet."""


def attach(run):
    run.spans.module('resnet', run.driver.layers()['resnet'])


def read(run):
    return run.spans.total_ms('resnet') / run.window.requests
