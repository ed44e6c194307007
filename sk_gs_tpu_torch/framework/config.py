"""Config system: YAML with ``__base__`` inheritance, deep merge, overrides
(a copy of ``sk_gs_tpu/framework/config.py``, reading and writing YAML with
the port's own ``yamlio``).

``__base__`` (a path or a list of paths, relative to the file) is loaded
first and merged under the file; ``__replace__: true`` in a sub-dict
replaces the base's dict instead of merging into it. Overrides use dotted
keys: ``--set train.lr=1e-3 model.num_superpoints=256``.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from . import yamlio


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Merge ``overlay`` into ``base`` (overlay wins); ``__replace__`` skips
    merging."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k == '__replace__':
            continue
        if (isinstance(v, dict) and isinstance(out.get(k), dict)
                and not v.get('__replace__', False)):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path) -> Dict[str, Any]:
    path = Path(path)
    cfg = yamlio.loads(path.read_text()) or {}
    bases = cfg.pop('__base__', None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = deep_merge(merged, load_yaml(path.parent / b))
    return deep_merge(merged, cfg)


def parse_value(s: str) -> Any:
    """An override's value: JSON first, then a YAML scalar."""
    try:
        return json.loads(s)
    except ValueError:
        return yamlio.loads(s)


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]
                    ) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` strings."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f'override must be key=value: {ov}')
        key, _, val = ov.partition('=')
        parts = key.split('.')
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(val)
    return cfg


def make_config(yaml_path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {}
    if yaml_path:
        cfg = load_yaml(yaml_path)
    return apply_overrides(cfg, overrides)


def save_config(cfg: Dict[str, Any], path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yamlio.dumps(cfg))
