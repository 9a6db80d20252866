"""Find what a cell needs by the names ``BENCHMARK.json`` gives.

Under the manifest's directory ``root``:

- a configuration is ``configs/<name>.json`` as its entry names it
  (``file``), and its plain reference ``perfbench/reference/<family>.py``;
- a traffic mix is ``perfbench/traffic/<mix>.json``, parameters for
  ``perfbench/traffic.py``;
- the driver of a (family, traffic kind) pair is
  ``perfbench/drivers/<family>_<kind>.py``;
- a metric is ``perfbench/end_to_end/<name>.py`` or
  ``perfbench/metrics/<name>.py``, a reader with ``read(run)`` (and, for a
  per-layer metric, optionally ``attach(run)`` before the window);
- the limits of a cell's output comparison are
  ``perfbench/limits/<cell>.json``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and manifest entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    root: Path
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    limits: Dict[str, dict] = field(default_factory=dict)


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """A metric with ``workloads`` applies to those cells; one without,
    to every cell (end to end) or to every cell that reports the metric
    it moves (per layer)."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    return e2e_names is None or metric['moves'] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in manifest['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in {root / "BENCHMARK.json"}; '
                       f'there are {sorted(cells)}')
    w = cells[name]
    cfg_entry = {c['name']: c for c in manifest['configs']}[w['config']]
    config = json.loads((root / cfg_entry['file']).read_text())
    traffic = json.loads(
        (root / 'perfbench' / 'traffic' / f'{w["traffic"]}.json').read_text())
    e2e = [m for m in manifest['end_to_end'] if _applies(m, name)]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in manifest['per_layer']
                 if _applies(m, name, names)]
    limits_file = root / 'perfbench' / 'limits' / f'{name}.json'
    limits = (json.loads(limits_file.read_text()) if limits_file.exists()
              else {})
    return Cell(name, w['chips'], root, config, traffic, e2e, per_layer,
                limits)


def load_file(path: Path, tag: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own."""
    if not path.exists():
        raise FileNotFoundError(f'{path} (the {tag} named in the manifest)')
    spec = importlib.util.spec_from_file_location(
        f'perfbench_{tag}_{path.stem.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell) -> ModuleType:
    family, kind = cell.config['family'], cell.traffic['kind']
    return load_file(cell.root / 'perfbench' / 'drivers'
                     / f'{family}_{kind}.py', 'driver')


def metric(cell: Cell, entry: dict, per_layer: bool) -> ModuleType:
    folder = 'metrics' if per_layer else 'end_to_end'
    return load_file(cell.root / 'perfbench' / folder / f'{entry["name"]}.py',
                     'metric')
