"""What the benchmark imports: never JAX or the JAX package (whole
top-level names: ``omnihd_scenes_tpu_torch`` is not
``omnihd_scenes_tpu``), and its references nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FILES = sorted(PKG.rglob('*.py'))


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_by_whole_top_level_name(path):
    bad = [m for m in _imports(path)
           if m.split('.')[0] in harness.FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize(
    'path', sorted((PKG / 'reference').rglob('*.py')),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    bad = [m for m in _imports(path)
           if m.split('.')[0] == 'omnihd_scenes_tpu_torch']
    assert not bad, f'{path} imports {bad}'


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'omnihd_scenes_tpu_torch_fake', sys)
    assert 'omnihd_scenes_tpu_torch_fake' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert 'jax.numpy' in harness.forbidden_modules()


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    """No CUDA device (this machine): exit non-zero, nothing on stdout;
    never a fall back to the CPU."""
    proc = subprocess.run(
        [sys.executable, '-m', 'perfbench.run', '--workload',
         'bevfusion_serve_b4', '--seed', str(2 ** 31 + 5), '--seconds', '1',
         '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={'PATH': '/usr/bin:/bin', 'HOME': str(tmp_path),
                          'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert proc.stdout == ''
    assert 'CUDA' in proc.stderr
