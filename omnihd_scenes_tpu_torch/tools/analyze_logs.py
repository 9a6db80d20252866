"""Training-log analysis CLI (counterpart of
``omnihd_scenes_tpu/tools/analyze_logs.py``).

Parity target: ``tools/analysis_tools/analyze_logs.py`` — plots metric
curves from the ``<name>.log.json`` stream that ``train/loop.py``'s
``JsonLogger`` writes and reports iteration-time stats.  matplotlib is
imported only to plot.

Usage:
    python -m omnihd_scenes_tpu_torch.tools.analyze_logs cal_train_time LOG
    python -m omnihd_scenes_tpu_torch.tools.analyze_logs plot_curve LOG \
        [--keys loss ...] [--out curve.png]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np


def load_json_log(path: str):
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def cal_train_time(records):
    times = [r['time'] for r in records
             if r.get('mode') == 'train' and 'time' in r]
    if not times:
        print('no timing records')
        return
    times = np.asarray(times[1:] or times)  # drop compile iteration
    print(f'slowest iter time: {times.max():.4f}s')
    print(f'fastest iter time: {times.min():.4f}s')
    print(f'average iter time: {times.mean():.4f}s +- {times.std():.4f}')


def plot_curve(records, keys, out: str):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    series = defaultdict(list)
    for r in records:
        if r.get('mode') != 'train':
            continue
        for k in keys:
            if k in r:
                series[k].append(r[k])
    plt.figure(figsize=(8, 5))
    for k, vals in series.items():
        plt.plot(vals, label=k)
    plt.xlabel('log step')
    plt.legend()
    plt.grid(alpha=0.3)
    plt.savefig(out)
    print('curve saved to', out)


def main(argv=None):
    p = argparse.ArgumentParser(description='Analyze training logs')
    sub = p.add_subparsers(dest='task', required=True)
    pt = sub.add_parser('cal_train_time')
    pt.add_argument('json_log')
    pc = sub.add_parser('plot_curve')
    pc.add_argument('json_log')
    pc.add_argument('--keys', nargs='+', default=['loss'])
    pc.add_argument('--out', default='curve.png')
    args = p.parse_args(argv)

    records = load_json_log(args.json_log)
    if args.task == 'cal_train_time':
        cal_train_time(records)
    else:
        plot_curve(records, args.keys, args.out)


if __name__ == '__main__':
    main()
