"""Tracking-metric curve rendering (counterpart of
``omnihd_scenes_tpu/eval/tracking/render.py``; matplotlib is imported
when a curve is drawn, as in the detection renderer).

Parity target: ``newscenes_devkit/eval/tracking/render.py`` —
``recall_metric_curve`` (one PNG per metric: metric vs recall, one line
per class) and ``summary_plot`` (grid of all curve metrics).  Headless
matplotlib (Agg), same artifact layout as the detection renderer.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

# Metrics rendered against the recall axis (reference summary_plot set).
CURVE_METRICS = ('motar', 'mota', 'motp', 'faf', 'ids', 'frag',
                 'tid', 'lgd')


def _plt():
    from omnihd_scenes_tpu_torch.eval.detection.render import _plt as pyplot
    return pyplot()


def recall_metric_curve(md_per_class: Dict[str, Dict], metric: str,
                        savepath: str, min_recall: float = 0.1) -> None:
    """One metric vs recall, one line per class."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(7.5, 5))
    for cls, md in md_per_class.items():
        rec = np.asarray(md['recall'])
        val = np.asarray(md[metric], np.float64)
        ok = np.isfinite(val)
        ax.plot(rec[ok], val[ok], label=cls)
    ax.set_xlabel('Recall')
    ax.set_ylabel(metric.upper())
    ax.set_xlim(min_recall, 1.0)
    ax.legend(loc='best')
    ax.set_title(f'{metric.upper()} vs recall')
    fig.tight_layout()
    fig.savefig(savepath)
    plt.close(fig)


def summary_plot(md_per_class: Dict[str, Dict], savepath: str,
                 min_recall: float = 0.1) -> None:
    """Grid of every curve metric (reference summary_plot)."""
    plt = _plt()
    ncols = 2
    nrows = -(-len(CURVE_METRICS) // ncols)
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols,
                             figsize=(7.5 * ncols, 4 * nrows))
    for ax, metric in zip(axes.ravel(), CURVE_METRICS):
        for cls, md in md_per_class.items():
            rec = np.asarray(md['recall'])
            val = np.asarray(md[metric], np.float64)
            ok = np.isfinite(val)
            ax.plot(rec[ok], val[ok], label=cls)
        ax.set_xlabel('Recall')
        ax.set_ylabel(metric.upper())
        ax.set_xlim(min_recall, 1.0)
    axes.ravel()[0].legend(loc='best')
    for ax in axes.ravel()[len(CURVE_METRICS):]:
        ax.axis('off')
    fig.tight_layout()
    fig.savefig(savepath)
    plt.close(fig)


def render_tracking_curves(md_per_class: Dict[str, Dict],
                           output_dir: str) -> None:
    """Write the full artifact set under ``output_dir/plots``."""
    plots = os.path.join(output_dir, 'plots')
    os.makedirs(plots, exist_ok=True)
    summary_plot(md_per_class, os.path.join(plots, 'summary.png'))
    for metric in CURVE_METRICS:
        recall_metric_curve(md_per_class, metric,
                            os.path.join(plots, f'{metric}.png'))
