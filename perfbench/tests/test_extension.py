"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and manifest entries; the harness finds them by name
with no edit to a file that exists."""

import hashlib
import json
import time

import torch

from perfbench import harness, manifest
from perfbench.tests import minis

METRIC = '''"""Calls the traced window completed (a test's metric)."""


def attach(run):
    run.spans.module('head', run.driver.layers()['model'].head)


def read(run):
    return float(len(run.spans.pairs['head']))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / 'perfbench').rglob('*') if p.is_file()}


def test_new_files_resolve_by_name(tmp_path):
    root = minis.mini_root(tmp_path)
    before = _digests(root)
    (root / 'perfbench' / 'metrics' / 'head_calls.test.py').write_text(
        METRIC)
    mix = minis.serve_mini()
    mix['batch'] = 1
    (root / 'perfbench' / 'traffic' / 'serve_b1_mini.json').write_text(
        json.dumps(mix))
    cfg = minis.bevfusion_mini()
    cfg['model']['lic'] = 64
    (root / 'perfbench' / 'configs' / 'bevfusion_wide.json').write_text(
        json.dumps(cfg))
    doc = json.loads((root / 'BENCHMARK.json').read_text())
    doc['configs'].append({'name': 'bevfusion_wide', 'source': 'tests',
                           'file': 'perfbench/configs/bevfusion_wide.json',
                           'reduced': [], 'why': 'test'})
    doc['workloads'].append({'name': 'new_cell', 'config': 'bevfusion_wide',
                             'traffic': 'serve_b1_mini', 'chips': 1,
                             'why': 'test'})
    doc['per_layer'].append({'name': 'head_calls.test', 'unit': 'calls',
                             'better': 'higher', 'source': 'program_span',
                             'layer': 'test', 'moves': 'samples_per_s',
                             'workloads': ['new_cell']})
    for m in doc['end_to_end']:
        if 'bevfusion_serve_b4' in m.get('workloads', ()):
            m['workloads'].append('new_cell')
    (root / 'BENCHMARK.json').write_text(json.dumps(doc))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())

    cell = manifest.load_cell('new_cell', root)
    assert cell.config['model']['lic'] == 64
    assert [m['name'] for m in cell.per_layer] == ['head_calls.test']
    line = harness.run_cell(cell, 2 ** 40 + 1, 0.5, True,
                            torch.device('cpu'), time.perf_counter())
    calls = line['metrics']['head_calls.test']
    assert calls['unit'] == 'calls' and calls['value'] == line['attempted']
    line = harness.run_cell(cell, 2 ** 40 + 1, 0.5, False,
                            torch.device('cpu'), time.perf_counter())
    assert set(line['metrics']) == {'samples_per_s', 'setup_s'}
    assert line['metrics']['samples_per_s']['value'] > 0
