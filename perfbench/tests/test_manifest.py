"""``BENCHMARK.json`` against the benchmark contract's shape rules, and
every name it gives resolving to a file."""

import json
import re

import pytest

from perfbench import manifest
from perfbench.tests.minis import ROOT

DOC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in DOC['workloads']]


def test_top_level_keys_and_limits():
    assert set(DOC) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert DOC['paths'] == ['perfbench']
    assert 1 <= DOC['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    cells = len(DOC['workloads'])
    four = sum(w['chips'] == 4 for w in DOC['workloads'])
    assert four <= max(1, cells // 4)
    for w in DOC['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert len(w['why']) <= 200
    for c in DOC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/')
        assert (ROOT / c['file']).exists()
    names = [m['name'] for m in DOC['end_to_end'] + DOC['per_layer']]
    names += CELLS + [c['name'] for c in DOC['configs']]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_metrics():
    e2e = {m['name']: m for m in DOC['end_to_end']}
    assert e2e['setup_s']['bound'] == 0.25 and 'workloads' not in e2e[
        'setup_s']
    for m in DOC['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in DOC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert UNIT.match(m['unit'])
        for cell in m['workloads']:
            reported = [n for n, e in e2e.items()
                        if cell in e.get('workloads', CELLS)]
            assert m['moves'] in reported, (m['name'], cell)


@pytest.mark.parametrize('cell', CELLS)
def test_every_cell_resolves(cell):
    c = manifest.load_cell(cell)
    assert {m['name'] for m in c.end_to_end} > {'setup_s'}
    assert c.per_layer
    assert manifest.driver(c).Driver
    for m in c.end_to_end:
        assert manifest.metric(c, m, per_layer=False).read
    for m in c.per_layer:
        assert manifest.metric(c, m, per_layer=True).read
    assert c.limits, 'every cell has its limits file'
