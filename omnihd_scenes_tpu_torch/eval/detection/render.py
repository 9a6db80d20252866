"""PR / TP curve rendering (counterpart of
``omnihd_scenes_tpu/eval/detection/render.py``; reference
``newscenes_devkit/eval/detection/render.py``): the summary grid,
per-class PR and TP curves, per-distance PR, and a BEV plot of one
sample's boxes.

matplotlib is imported by the drawing functions, not by this module, so
the package imports where it is missing; a drawing function then raises
an ``ImportError`` that says how to evaluate without the curves.
"""

from __future__ import annotations

import numpy as np

from omnihd_scenes_tpu_torch.eval.detection.constants import (
    DETECTION_COLORS, PRETTY_DETECTION_NAMES, PRETTY_TP_METRICS, TP_METRICS,
    TP_METRICS_UNITS)

NO_MATPLOTLIB = ('rendering the PR and TP curves needs matplotlib, which is '
                 'not installed; evaluate without them with '
                 '--render_curves 0 (render_curves=False)')


def _plt():
    """matplotlib's pyplot on the headless Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(NO_MATPLOTLIB) from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _setup_axis(ax, xlabel=None, ylabel=None, xlim=1, ylim=1,
                min_precision=None, min_recall=None, title=None):
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.set_xlim(0, xlim)
    if ylim is not None:
        ax.set_ylim(0, ylim)
    if min_recall is not None:
        ax.axvline(x=min_recall, linestyle='--', color=(0, 0, 0, 0.3))
    if min_precision is not None:
        ax.axhline(y=min_precision, linestyle='--', color=(0, 0, 0, 0.3))
    return ax


def class_pr_curve(md_list, metrics, detection_name, min_precision,
                   min_recall, savepath=None, ax=None):
    """Recall-precision curves of one class over all distance thresholds."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(7.5, 5))
    _setup_axis(ax, xlabel='Recall', ylabel='Precision',
                min_precision=min_precision, min_recall=min_recall,
                title=PRETTY_DETECTION_NAMES[detection_name] + ' PR')
    for md, dist_th in md_list.get_class_data(detection_name):
        ap = metrics.get_label_ap(detection_name, dist_th)
        ax.plot(md.recall, md.precision,
                label=f'dist={dist_th}m (AP {ap * 100:.1f})')
    ax.legend(loc='best')
    if savepath is not None:
        plt.savefig(savepath)
        plt.close()


def class_tp_curve(md_list, metrics, detection_name, min_recall, dist_th_tp,
                   savepath=None, ax=None):
    """TP-error curves of one class at the TP distance threshold."""
    plt = _plt()
    md = md_list[(detection_name, dist_th_tp)]
    if ax is None:
        _, ax = plt.subplots(figsize=(7.5, 5))
    # Cap the y-axis a little above the largest TP error in the valid range.
    rel_ind = md.max_recall_ind + 1
    if rel_ind > 0:
        ylimit = max(max(getattr(md, m)[:rel_ind].tolist() or [1.0])
                     for m in TP_METRICS) * 1.1
    else:
        ylimit = 1.0
    ylimit = max(ylimit, 0.1)  # keep the axis non-degenerate when errors ~ 0
    _setup_axis(ax, xlabel='Recall', ylabel='Error', ylim=ylimit,
                min_recall=min_recall,
                title=PRETTY_DETECTION_NAMES[detection_name] + ' TP errors')
    for metric in TP_METRICS:
        tp = metrics.get_label_tp(detection_name, metric)
        if np.isnan(tp):
            continue
        ax.plot(md.recall[:rel_ind], getattr(md, metric)[:rel_ind],
                label=f'{PRETTY_TP_METRICS[metric]} '
                      f'({tp:.2f} {TP_METRICS_UNITS[metric]})')
    ax.axvline(x=md.max_recall, linestyle='-.', color=(0, 0, 0, 0.3))
    ax.legend(loc='best')
    if savepath is not None:
        plt.savefig(savepath)
        plt.close()


def dist_pr_curve(md_list, metrics, dist_th, min_precision, min_recall,
                  savepath=None):
    """PR curves of all classes at a single distance threshold."""
    plt = _plt()
    _, ax = plt.subplots(figsize=(7.5, 5))
    _setup_axis(ax, xlabel='Recall', ylabel='Precision',
                min_precision=min_precision, min_recall=min_recall,
                title=f'PR @ dist={dist_th}m')
    for md, detection_name in md_list.get_dist_data(dist_th):
        ap = metrics.get_label_ap(detection_name, dist_th)
        ax.plot(md.recall, md.precision,
                color=DETECTION_COLORS[detection_name],
                label=f'{PRETTY_DETECTION_NAMES[detection_name]} '
                      f'(AP {ap * 100:.1f})')
    ax.legend(loc='best')
    if savepath is not None:
        plt.savefig(savepath)
        plt.close()


def summary_plot(md_list, metrics, min_precision, min_recall, dist_th_tp,
                 savepath=None):
    """Grid of per-class PR + TP panels."""
    plt = _plt()
    classes = sorted({name for name, _ in md_list.md.keys()})
    n = len(classes)
    fig, axes = plt.subplots(nrows=n, ncols=2, figsize=(15, 5 * n),
                             squeeze=False)
    for i, detection_name in enumerate(classes):
        class_pr_curve(md_list, metrics, detection_name, min_precision,
                       min_recall, ax=axes[i][0])
        class_tp_curve(md_list, metrics, detection_name, min_recall,
                       dist_th_tp, ax=axes[i][1])
    plt.tight_layout()
    if savepath is not None:
        plt.savefig(savepath)
        plt.close()


def visualize_sample(newsc, sample_token, gt_boxes, pred_boxes,
                     eval_range: float = 60.0, conf_th: float = 0.15,
                     savepath: str = None):
    """BEV plot of GT vs predicted eval boxes for one sample: GT in green,
    predictions above ``conf_th`` in red, the eval range as a circle."""
    from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

    plt = _plt()
    _, ax = plt.subplots(figsize=(9, 9))

    def draw(boxes, color, check_conf=False):
        for box in boxes:
            if check_conf and box.detection_score < conf_th:
                continue
            cx, cy = box.translation[0], box.translation[1]
            w, l = box.size[0], box.size[1]
            yaw = np.arctan2(
                *(Quaternion(box.rotation).rotation_matrix
                  @ np.array([1, 0, 0]))[[1, 0]])
            c, s = np.cos(yaw), np.sin(yaw)
            local = np.array([[l, l, -l, -l, l], [w, -w, -w, w, w]]) / 2
            pts = np.array([[c, -s], [s, c]]) @ local
            ax.plot(pts[0] + cx, pts[1] + cy, color=color, linewidth=1.0)

    draw(gt_boxes[sample_token] if hasattr(gt_boxes, '__getitem__')
         else gt_boxes, 'g')
    draw(pred_boxes[sample_token] if hasattr(pred_boxes, '__getitem__')
         else pred_boxes, 'r', check_conf=True)

    circle = plt.Circle((0, 0), eval_range, fill=False, linestyle='--',
                        color='gray')
    ax.add_patch(circle)
    ax.plot(0, 0, 'x', color='black')
    ax.set_xlim(-eval_range * 1.1, eval_range * 1.1)
    ax.set_ylim(-eval_range * 1.1, eval_range * 1.1)
    ax.set_aspect('equal')
    ax.set_title(f'GT (green) vs predictions (red): {sample_token}')
    if savepath is not None:
        plt.savefig(savepath)
        plt.close()
