"""Pytree checkpoints in the JAX package's on-disk format, numpy only.

``arrays.npz`` holds one array per leaf under a flat key path such as
``cost/table_mlp/0/w`` (dict keys in sorted order, list indices as
numbers, as ``jax.tree_util`` flattens them); ``meta.json`` maps each key
to its dtype, with bfloat16 stored as a ``uint16`` view.  Checkpoints
written here restore with ``repro.checkpoint.restore_pytree`` and the
other way round.  ``save_state`` / ``load_state`` are the serving state's
versioned envelope (``state.npz`` + ``state.json``), also the reference's
format both ways.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{key path: leaf} in ``jax.tree_util`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix]


def save_pytree(tree, path: str):
    """Write a tree of numpy arrays or tensors (bfloat16 tensors kept as
    ``uint16`` views with a ``bfloat16`` tag)."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                arrays[k] = v.view(torch.int16).numpy().view(np.uint16)
                meta[k] = "bfloat16"
                continue
            v = v.numpy()
        arr = np.asarray(v)
        arrays[k] = arr
        meta[k] = str(arr.dtype)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def restore_pytree(template, path: str):
    """Restore into the structure of ``template``: numpy leaves, except
    bfloat16 ones, which come back as ``torch.bfloat16`` tensors."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in _flatten(template):
            arr = np.array(data[k])
            if meta[k] == "bfloat16":
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            flat[k] = arr
    return _unflatten(template, flat)


# ---- versioned state envelopes (service crash recovery) ----------------------

STATE_VERSION = 1


def save_state(path: str, arrays: dict, meta: dict):
    """Versioned state checkpoint: named numpy arrays (``state.npz``) plus
    a JSON metadata envelope (``state.json``), the reference's format, so
    a state written by either package loads in the other.  For *service*
    state -- heterogeneous arrays plus JSON-serializable metadata --
    where ``save_pytree`` is for template-shaped parameters."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})
    envelope = {"state_version": STATE_VERSION, "meta": meta}
    with open(os.path.join(path, "state.json"), "w") as fh:
        json.dump(envelope, fh)


def load_state(path: str) -> tuple[dict, dict]:
    """Load a ``save_state`` checkpoint -> ``(arrays, meta)``.

    Raises ``ValueError`` on an unknown ``state_version``: a crashed
    process must not warm-restart from a checkpoint it cannot decode.
    """
    with open(os.path.join(path, "state.json")) as fh:
        envelope = json.load(fh)
    version = envelope.get("state_version")
    if version != STATE_VERSION:
        raise ValueError(
            f"unsupported state checkpoint version {version!r} "
            f"(this build reads version {STATE_VERSION})")
    with np.load(os.path.join(path, "state.npz")) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    return arrays, envelope["meta"]
