"""Checkpointing: parameter tree <-> ``.npz`` with structure-preserving
keys (the torch twin of ``repro/checkpoint/checkpoint.py``, in its
layout: a JAX checkpoint loads here, and one saved here loads there).

Leaves are copied to the host and saved flat under ``/``-joined keys, a
list or tuple entry as ``#i``, beside a ``__meta__`` JSON of the sorted
keys and the step.  Sharded placement (``mesh``, ``specs``) waits for
multi-device support.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import tree_map

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save(path: str, tree, step: Optional[int] = None) -> None:
    arrays = {k: _host(v) for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"keys": sorted(arrays), "step": step}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, like=None):
    """Restore a checkpoint as torch tensors.  With ``like`` (a tree of
    tensors) the result has its structure, each leaf in its dtype and on
    its device; without it, a nested dict with string keys (``#i`` keys
    stay strings), on the CPU."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if like is None:
        tree: dict = {}
        for k, v in arrays.items():
            parts = k.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(v)
        return tree
    flat_like = _flatten(like)
    missing = set(flat_like) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    keys = iter(_flatten(like))      # the order tree_map visits the leaves
    return tree_map(lambda proto: torch.from_numpy(arrays[next(keys)]).to(
        dtype=proto.dtype, device=proto.device), like)
