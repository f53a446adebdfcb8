"""Checkpoints of solver state (port of
``circuitmap_tpu/utils/checkpoint.py``).

A nested dict (or NamedTuple) of arrays serialises to one ``.npz`` in
the JAX package's interchange format: keys are the ``/``-joined paths,
a None leaf is an empty array under ``<path>#none``, and the write is
atomic (a temporary file, then ``os.replace``), so a crash mid-save
never corrupts the only checkpoint. Tensors are written as numpy arrays
(pulled to the host). The port's fits keep their ``torch.Generator``
state under :data:`GENERATOR_KEY`; a checkpoint written by the JAX
package holds a ``jax.random`` key instead.
"""

from __future__ import annotations

import os

import numpy as np
import torch

GENERATOR_KEY = "torch_generator"


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):  # NamedTuple
        items = tree._asdict().items()
    else:
        raise TypeError(f"unsupported tree node: {type(tree)}")
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "_asdict"):
            flat.update(_flatten(v, key + "/"))
        elif v is None:
            flat[key + "#none"] = np.zeros(0)
        else:
            flat[key] = _host(v)
    return flat


def _unflatten(flat):
    tree: dict = {}
    for key, val in flat.items():
        none = key.endswith("#none")
        if none:
            key = key[: -len("#none")]
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if none else val
    return tree


def save_state(path, state_tree):
    """Write a (possibly nested) dict or NamedTuple of arrays or tensors
    to ``path`` as ``.npz``, atomically: the file is either the old
    checkpoint or the new one, never a torn write, and no temporary file
    is left behind."""
    path = str(path)
    tmp = path + ".tmp"
    try:
        np.savez(tmp, **_flatten(state_tree))
        # np.savez appends .npz to names without that extension
        if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
            tmp = tmp + ".npz"
        os.replace(tmp, path)
    finally:
        for leftover in {tmp, tmp + ".npz"}:
            try:
                os.unlink(leftover)
            except FileNotFoundError:
                pass


def load_state(path):
    """A ``.npz`` checkpoint back as a nested dict of numpy arrays."""
    with np.load(str(path), allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})


def generator_state(generator):
    """A ``torch.Generator``'s state as a uint8 array, for a checkpoint."""
    return generator.get_state().numpy().copy()


def restore_generator(generator, state, path):
    """Set ``generator`` to a checkpoint's :func:`generator_state`;
    ``state`` None means the checkpoint at ``path`` was not written by
    the port (the JAX package keeps a ``jax.random`` key, whose stream
    a ``torch.Generator`` cannot continue)."""
    if state is None:
        raise ValueError(
            f"checkpoint {path} holds no torch.Generator state (key "
            f"{GENERATOR_KEY!r}): it was written by the JAX package, whose "
            "jax.random key the port's random stream cannot continue. "
            "Resume it with circuitmap_tpu, or start the fit anew")
    generator.set_state(torch.from_numpy(np.asarray(state, np.uint8)))
