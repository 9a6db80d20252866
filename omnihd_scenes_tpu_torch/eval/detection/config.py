"""Detection config factory (reference
``newscenes_devkit/eval/detection/config.py``): loads a named JSON from
the package ``configs/`` directory into a ``DetectionConfig``."""

import json
import os

from omnihd_scenes_tpu_torch.eval.detection.data_classes import DetectionConfig


def config_factory(configuration_name: str) -> DetectionConfig:
    this_dir = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(this_dir, 'configs', f'{configuration_name}.json')
    assert os.path.exists(cfg_path), \
        f'Requested unknown configuration {configuration_name}'
    with open(cfg_path, 'r') as f:
        return DetectionConfig.deserialize(json.load(f))
