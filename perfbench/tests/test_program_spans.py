"""The readers of the program's own spans (``perfbench/program_spans.py``
and the metrics that read through it): in a traced run of each mini cell
on the CPU every one of them reports, and the upload's idle time lies
within its host time; against a program without the span store (an
older commit) they report nothing and raise nothing."""

import json
import time

import pytest
import torch

from perfbench import harness, manifest, program_spans
from perfbench.tests import minis

CPU = torch.device('cpu')
SEED = 2 ** 40 + 29
DOC = json.loads((minis.ROOT / 'BENCHMARK.json').read_text())
# The metrics whose readers go through ``program_spans``.
READERS = {m['name']: m['workloads'] for m in DOC['per_layer']
           if 'program_spans' in (minis.ROOT / 'perfbench' / 'metrics'
                                  / f'{m["name"]}.py').read_text()}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return minis.mini_root(tmp_path_factory.mktemp('bench'))


@pytest.fixture(autouse=True)
def spans_off():
    timing = program_spans.store()
    yield
    timing.enable(False)
    timing.reset(setup=True)


def _traced(root, cell):
    return harness.run_cell(manifest.load_cell(f'{cell}_mini', root), SEED,
                            0.5, True, CPU, time.perf_counter())


@pytest.mark.parametrize('cell', sorted(minis.MINI_CELLS))
def test_every_span_metric_reports(root, cell):
    line = _traced(root, cell)
    want = {n for n, cells in READERS.items() if cell in cells}
    assert want, cell
    got = line['metrics']
    for name in want:
        assert name in got, name
        assert got[name]['value'] > 0, (name, got[name])
    if 'upload_idle_ms' in want:
        assert got['upload_idle_ms']['value'] <= got['upload_host_ms'][
            'value']


@pytest.mark.parametrize('cell', sorted(minis.MINI_CELLS))
def test_a_program_without_spans_reports_none(root, cell, monkeypatch):
    monkeypatch.setattr(program_spans, 'store', lambda: None)
    line = _traced(root, cell)
    assert not set(READERS) & set(line['metrics'])
    assert line['metrics']                  # the other metrics still read
