"""Python-file config system.

Parity target: mmcv ``Config.fromfile`` + ``--cfg-options`` as used by
the reference CLIs (``tools/train.py:74-83,112-146``): configs are plain
Python files whose module-level names become config keys, ``_base_``
lists are merged (later overrides earlier, dicts deep-merged), and
dotted overrides mutate nested keys.
"""

from __future__ import annotations

import ast
import copy
import os.path as osp
import types
from typing import Any, Dict, List, Optional


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)
                and not v.get('_delete_', False)):
            out[k] = _deep_merge(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop('_delete_', None)
            out[k] = v
    return out


def _exec_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    module = types.ModuleType('_cfg')
    module.__file__ = path
    exec(compile(src, path, 'exec'), module.__dict__)
    return {k: v for k, v in module.__dict__.items()
            if not k.startswith('__') and not isinstance(
                v, (types.ModuleType, types.FunctionType, type))}


class Config:
    """Attribute/dict hybrid over a nested config mapping."""

    def __init__(self, cfg_dict: Dict[str, Any], filename: str = None):
        object.__setattr__(self, '_cfg', cfg_dict)
        object.__setattr__(self, 'filename', filename)

    @classmethod
    def fromfile(cls, path: str) -> 'Config':
        cfg = _exec_config(path)
        bases = cfg.pop('_base_', [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for base in bases:
            base_cfg = cls.fromfile(osp.join(osp.dirname(path), base))
            merged = _deep_merge(merged, base_cfg._cfg)
        return cls(_deep_merge(merged, cfg), filename=path)

    def merge_from_options(self, options: Optional[List[str]]):
        """Apply 'a.b.c=value' dotted overrides (values parsed as Python
        literals when possible)."""
        for opt in options or []:
            key, _, raw = opt.partition('=')
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node = self._cfg
            parts = key.split('.')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

    # -- access --------------------------------------------------------------
    def __getattr__(self, name):
        try:
            v = self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        self._cfg[name] = value

    def __getitem__(self, name):
        return self._cfg[name]

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        v = self._cfg.get(name, default)
        return Config(v) if isinstance(v, dict) else v

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg)

    def dump(self, path: str):
        import pprint
        with open(path, 'w') as f:
            for k, v in self._cfg.items():
                f.write(f'{k} = {pprint.pformat(v)}\n')

    def __repr__(self):
        return f'Config({self._cfg!r})'
