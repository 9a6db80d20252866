from omnihd_scenes_tpu_torch.eval.detection.algo import accumulate, calc_ap, calc_tp
from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
from omnihd_scenes_tpu_torch.eval.detection.data_classes import (
    DetectionBox, DetectionConfig, DetectionMetricData,
    DetectionMetricDataList, DetectionMetrics)
from omnihd_scenes_tpu_torch.eval.detection.evaluate import (DetectionEval,
                                                       NewScenesEval)

__all__ = ['accumulate', 'calc_ap', 'calc_tp', 'config_factory',
           'DetectionBox', 'DetectionConfig', 'DetectionMetricData',
           'DetectionMetricDataList', 'DetectionMetrics', 'DetectionEval',
           'NewScenesEval']
