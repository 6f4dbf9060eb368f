"""Parameter trees in .npz files.

The JAX package's deployable model directories (its `bin/ckpt_resave.py
--out_dir`) keep each sub-model's JAX parameter tree as one flat .npz whose
keys are "/"-joined dict paths.  `load_params_npz` reads one back into nested
dicts of numpy arrays, which the port's `convert.py` turns into state_dicts;
`save_params_npz` writes nested dicts in the same format (numpy only).
"""
from __future__ import annotations

import numpy as np


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": np.ndarray}, keys in sorted order."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(flatten_params(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def unflatten_params(flat: dict) -> dict:
    """{"a/b/c": arr} -> nested dicts (the inverse of flatten_params)."""
    out: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return out


def save_params_npz(path: str, tree: dict) -> None:
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})
