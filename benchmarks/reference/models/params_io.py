"""Pickle-free checkpoint I/O: parameter pytrees as flat, path-keyed npz.

Copies of ``save_pytree_npz`` and ``load_pytree_npz`` from
audiotabs_tpu/models/params_io.py. Keys encode the tree path
(``spec_enc/#0/conv_w``); ``np.load`` stays at its safe default (no pickle).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np

# The trained checkpoints are the JAX package's data files, read by path.
WEIGHTS_DIR = Path(__file__).resolve().parents[3] / "audiotabs_tpu" / "weights"  # the checked-in checkpoints, read by path


def weights_path(env_var: str, filename: str) -> str:
    """Checkpoint path: ``$<env_var>`` when set ("off"/"none"/"0" → "", no
    weights), else the checked-in file. The same variables as the JAX loaders."""
    env = os.environ.get(env_var)
    if env is not None:
        return "" if env.lower() in ("off", "none", "0") else env
    return str(WEIGHTS_DIR / filename)


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k in tree:
            if "/" in str(k):
                raise ValueError(f"param key may not contain '/': {k!r}")
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}#{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_pytree_npz(path: str | os.PathLike, params: Any) -> None:
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    np.savez(path, **flat)


def load_pytree_npz(path: str | os.PathLike) -> Any:
    """Rebuild the nested dict/list pytree from a flat path-keyed npz."""
    data = np.load(path)
    root: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def _rebuild(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [_rebuild(v) for _, v in sorted(node.items(), key=lambda kv: int(kv[0][1:]))]
        return {k: _rebuild(v) for k, v in node.items()}

    return _rebuild(root)
