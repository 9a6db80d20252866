"""Official detection evaluation driver.

Parity target: ``newscenes_devkit/eval/detection/evaluate.py`` —
loads prediction JSON + GT from the DB, applies the OmniHD filters
(rectangular range, camera visibility, optional rainy/night slice),
accumulates PR per (class x dist_th), computes mAP + 4 TP errors at the
TP threshold, the NOS ("ODS") summary, and writes
``metrics_summary.json`` / ``metrics_details.json`` plus PR/TP curves
(``render.py``, which needs matplotlib; ``--render_curves 0`` skips
them).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Tuple

from omnihd_scenes_tpu_torch.devkit.database import NewScenes
from omnihd_scenes_tpu_torch.eval.common import (filter_eval_boxes, load_gt,
                                           load_prediction)
from omnihd_scenes_tpu_torch.eval.detection.algo import accumulate, calc_ap, calc_tp
from omnihd_scenes_tpu_torch.eval.detection.config import config_factory
from omnihd_scenes_tpu_torch.eval.detection.constants import TP_METRICS
from omnihd_scenes_tpu_torch.eval.detection.data_classes import (
    DetectionBox, DetectionConfig, DetectionMetricDataList, DetectionMetrics)
from omnihd_scenes_tpu_torch.eval.detection.render import (
    _plt, class_pr_curve, class_tp_curve, dist_pr_curve, summary_plot)

_ERR_NAME_MAPPING = {
    'trans_err': 'mATE',
    'scale_err': 'mASE',
    'orient_err': 'mAOE',
    'vel_err': 'mAVE',
}


class DetectionEval:
    """Loads, filters, evaluates and reports detection results."""

    def __init__(self,
                 newsc: NewScenes,
                 config: DetectionConfig,
                 result_path: str,
                 eval_set: str,
                 output_dir: str = None,
                 verbose: bool = True,
                 bad_conditions: bool = False):
        self.newsc = newsc
        self.result_path = result_path
        self.eval_set = eval_set
        self.output_dir = output_dir
        self.verbose = verbose
        self.cfg = config

        assert os.path.exists(result_path), 'The result file does not exist!'
        self.plot_dir = os.path.join(self.output_dir, 'plots')
        os.makedirs(self.output_dir, exist_ok=True)
        os.makedirs(self.plot_dir, exist_ok=True)

        if verbose:
            print('Initializing NewScenes detection evaluation')
        self.pred_boxes, self.meta = load_prediction(
            self.result_path, self.cfg.max_boxes_per_sample, DetectionBox,
            verbose=verbose)
        self.gt_boxes = load_gt(self.newsc, self.eval_set, DetectionBox,
                                verbose=verbose)

        assert set(self.pred_boxes.sample_tokens) == set(self.gt_boxes.sample_tokens), \
            "Samples in split doesn't match samples in predictions."

        if verbose:
            print('Filtering predictions')
        self.pred_boxes = filter_eval_boxes(newsc, self.pred_boxes,
                                            self.cfg.class_range,
                                            verbose=verbose,
                                            bad_conditions=bad_conditions)
        if verbose:
            print('Filtering ground truth annotations')
        self.gt_boxes = filter_eval_boxes(newsc, self.gt_boxes,
                                          self.cfg.class_range,
                                          verbose=verbose,
                                          bad_conditions=bad_conditions)

        assert set(self.pred_boxes.sample_tokens) == set(self.gt_boxes.sample_tokens), \
            "Samples in split doesn't match samples in predictions."
        self.sample_tokens = self.gt_boxes.sample_tokens

    def evaluate(self) -> Tuple[DetectionMetrics, DetectionMetricDataList]:
        """Accumulate per (class, dist_th), then fold into metrics."""
        start_time = time.time()

        if self.verbose:
            print('Accumulating metric data...')
        metric_data_list = DetectionMetricDataList()
        for class_name in self.cfg.class_names:
            for dist_th in self.cfg.dist_ths:
                md = accumulate(self.gt_boxes, self.pred_boxes, class_name,
                                self.cfg.dist_fcn_callable, dist_th,
                                verbose=self.verbose)
                metric_data_list.set(class_name, dist_th, md)

        if self.verbose:
            print('Calculating metrics...')
        metrics = DetectionMetrics(self.cfg)
        for class_name in self.cfg.class_names:
            for dist_th in self.cfg.dist_ths:
                md = metric_data_list[(class_name, dist_th)]
                metrics.add_label_ap(class_name, dist_th,
                                     calc_ap(md, self.cfg.min_recall,
                                             self.cfg.min_precision))
            for metric_name in TP_METRICS:
                md = metric_data_list[(class_name, self.cfg.dist_th_tp)]
                metrics.add_label_tp(class_name, metric_name,
                                     calc_tp(md, self.cfg.min_recall,
                                             metric_name))

        metrics.add_runtime(time.time() - start_time)
        return metrics, metric_data_list

    def render(self, metrics: DetectionMetrics,
               md_list: DetectionMetricDataList) -> None:
        """PR and TP curve PNGs under ``output_dir/plots`` (needs
        matplotlib: without it an ``ImportError`` names
        ``--render_curves 0``)."""
        if self.verbose:
            print('Rendering PR and TP curves')

        def savepath(name):
            return os.path.join(self.plot_dir, name + '.png')

        summary_plot(md_list, metrics, min_precision=self.cfg.min_precision,
                     min_recall=self.cfg.min_recall,
                     dist_th_tp=self.cfg.dist_th_tp,
                     savepath=savepath('summary'))
        for name in self.cfg.class_names:
            class_pr_curve(md_list, metrics, name, self.cfg.min_precision,
                           self.cfg.min_recall, savepath=savepath(name + '_pr'))
            class_tp_curve(md_list, metrics, name, self.cfg.min_recall,
                           self.cfg.dist_th_tp, savepath=savepath(name + '_tp'))
        for dist_th in self.cfg.dist_ths:
            dist_pr_curve(md_list, metrics, dist_th, self.cfg.min_precision,
                          self.cfg.min_recall,
                          savepath=savepath('dist_pr_' + str(dist_th)))

    def main(self, plot_examples: int = 0,
             render_curves: bool = True) -> Dict[str, Any]:
        if render_curves:
            _plt()  # without matplotlib, fail before evaluating
        metrics, metric_data_list = self.evaluate()

        if render_curves:
            self.render(metrics, metric_data_list)

        if self.verbose:
            print(f'Saving metrics to: {self.output_dir}')
        metrics_summary = metrics.serialize()
        metrics_summary['meta'] = self.meta.copy()
        with open(os.path.join(self.output_dir, 'metrics_summary.json'), 'w') as f:
            json.dump(metrics_summary, f, indent=2)
        with open(os.path.join(self.output_dir, 'metrics_details.json'), 'w') as f:
            json.dump(metric_data_list.serialize(), f, indent=2)

        print('mAP: %.4f' % metrics_summary['mean_ap'])
        for tp_name, tp_val in metrics_summary['tp_errors'].items():
            print('%s: %.4f' % (_ERR_NAME_MAPPING[tp_name], tp_val))
        print('NOS: %.4f' % metrics_summary['NOS'])
        print('Eval time: %.1fs' % metrics_summary['eval_time'])

        print()
        print('Per-class results:')
        print('%-20s\t%-6s\t%-6s\t%-6s\t%-6s\t%-6s'
              % ('Object Class', 'AP', 'ATE', 'ASE', 'AOE', 'AVE'))
        class_aps = metrics_summary['mean_dist_aps']
        class_tps = metrics_summary['label_tp_errors']
        for class_name in class_aps.keys():
            print('%-20s\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f'
                  % (class_name,
                     class_aps[class_name],
                     class_tps[class_name]['trans_err'],
                     class_tps[class_name]['scale_err'],
                     class_tps[class_name]['orient_err'],
                     class_tps[class_name]['vel_err']))

        return metrics_summary


class NewScenesEval(DetectionEval):
    """Backward-compatible alias (reference ``evaluate.py:262``)."""


def _main():
    parser = argparse.ArgumentParser(
        description='Evaluate NewScenes detection results.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('result_path', type=str)
    parser.add_argument('--output_dir', type=str, default='~/newscenes-metrics')
    parser.add_argument('--eval_set', type=str, default='val')
    parser.add_argument('--dataroot', type=str, default='/data/sets/newscenes')
    parser.add_argument('--version', type=str, default='v1.0-trainval')
    parser.add_argument('--config_path', type=str, default='')
    parser.add_argument('--plot_examples', type=int, default=0)
    parser.add_argument('--render_curves', type=int, default=1)
    parser.add_argument('--verbose', type=int, default=1)
    parser.add_argument('--bad_conditions', type=int, default=0)
    args = parser.parse_args()

    if args.config_path == '':
        cfg = config_factory('detection_newsc_config_final')
    else:
        with open(args.config_path, 'r') as f:
            cfg = DetectionConfig.deserialize(json.load(f))

    newsc = NewScenes(version=args.version, verbose=bool(args.verbose),
                      dataroot=args.dataroot)
    ev = DetectionEval(newsc, config=cfg,
                       result_path=os.path.expanduser(args.result_path),
                       eval_set=args.eval_set,
                       output_dir=os.path.expanduser(args.output_dir),
                       verbose=bool(args.verbose),
                       bad_conditions=bool(args.bad_conditions))
    ev.main(plot_examples=args.plot_examples,
            render_curves=bool(args.render_curves))


if __name__ == '__main__':
    _main()
