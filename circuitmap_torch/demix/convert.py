"""Checkpoint IO for the port's U-Net (port of
``circuitmap_tpu/demix/convert.py``).

The JAX package keeps demixer weights as a parameter pytree
``{block: {group: {leaf: array}}}`` (groups ``conv``/``deconv``/``bn``,
leaves ``w``/``b`` and ``scale``/``bias``/``running_mean``/
``running_var``) and stores it as a flat ``.npz`` keyed
``block/group/leaf``. The reference's Lightning ``.ckpt`` files hold
the torch state_dict of the same network, whose keys the port's
``NWDUNet`` uses (``dblock1.conv.weight`` ...). Conv1d weights are
[O, I, K] and ConvTranspose1d weights [I, O, K] in all three, so every
conversion is a pure re-keying with no transposes.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
         "running_mean": "running_mean", "running_var": "running_var"}
_BLOCKS = ([(f"dblock{i}", "conv") for i in range(1, 5)]
           + [(f"ublock{i}", "deconv") for i in range(1, 5)]
           + [("conv", "conv")])


def params_from_jax(params, dtype=torch.float32):
    """The JAX parameter pytree (leaves numpy or array-like) as an
    ``NWDUNet`` state_dict, in the reference's 63-entry layout.
    BatchNorm's ``num_batches_tracked`` counter, which the fixed momentum
    never reads, is set to 0."""
    sd = {}
    for block, kind in _BLOCKS:
        p = params[block]
        for group in (kind, "bn"):
            for leaf, val in p[group].items():
                sd[f"{block}.{group}.{_LEAF[leaf]}"] = torch.as_tensor(
                    np.array(val), dtype=dtype)
        sd[f"{block}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


# the JAX package's name for the same conversion
state_dict_from_params = params_from_jax


def _jax_layout(state_dict):
    """An ``NWDUNet`` state_dict as the JAX pytree's flat ``.npz`` keys
    (``block/group/leaf``) with float32 numpy values."""
    back = {("conv", "weight"): "w", ("conv", "bias"): "b",
            ("deconv", "weight"): "w", ("deconv", "bias"): "b",
            ("bn", "weight"): "scale", ("bn", "bias"): "bias",
            ("bn", "running_mean"): "running_mean",
            ("bn", "running_var"): "running_var"}
    flat = {}
    for key, val in state_dict.items():
        block, group, leaf = key.split(".")
        if (group, leaf) in back:
            flat[f"{block}/{group}/{back[(group, leaf)]}"] = (
                val.detach().cpu().numpy())
    return flat


def save_params(path, state_dict):
    """The in-repo ``.npz`` format (keys ``block/group/leaf``), which the
    JAX package's ``load_params`` reads."""
    np.savez(path, **_jax_layout(state_dict))


def load_lightning_checkpoint(path, dtype=torch.float32):
    """A Lightning ``.ckpt`` (the reference's pretrained demixers, or one
    written by :func:`save_lightning_checkpoint`) as an ``NWDUNet``
    state_dict. Unpickles the file, as the JAX package does: load only
    checkpoints from a trusted source."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return params_from_state_dict(sd, dtype=dtype)


def params_from_state_dict(sd, dtype=torch.float32):
    """A reference Lightning state_dict (tensors or ndarrays) as the
    port's ``NWDUNet`` state_dict: its 63 entries re-keyed as they are
    (the layouts agree), weights cast to ``dtype``; a missing
    ``num_batches_tracked`` is 0. The JAX function of this name builds
    its parameter pytree from the same keys."""
    out = {}
    for block, kind in _BLOCKS:
        for key in (f"{block}.{kind}.weight", f"{block}.{kind}.bias",
                    *(f"{block}.bn.{leaf}" for leaf in (
                        "weight", "bias", "running_mean", "running_var"))):
            out[key] = torch.as_tensor(sd[key]).to(dtype)
        out[f"{block}.bn.num_batches_tracked"] = torch.as_tensor(
            sd.get(f"{block}.bn.num_batches_tracked", 0))
    return out


def load_params(path, dtype=torch.float32):
    """A checkpoint as an ``NWDUNet`` state_dict: the in-repo ``.npz``
    format, or a Lightning ``.ckpt`` (also ``.pt``/``.pth``)."""
    p = str(path)
    if p.endswith((".ckpt", ".pt", ".pth")):
        return load_lightning_checkpoint(p, dtype=dtype)
    data = np.load(p)
    params: dict = {}
    for key in data.files:
        block, group, leaf = key.split("/")
        params.setdefault(block, {}).setdefault(group, {})[leaf] = data[key]
    return params_from_jax(params, dtype=dtype)


def save_lightning_checkpoint(path, state_dict, epoch=0, global_step=0):
    """Write an ``NWDUNet`` state_dict as a Lightning ``.ckpt`` in the
    container of the reference's shipped checkpoints: the top-level keys
    epoch / global_step / pytorch-lightning_version / state_dict /
    callbacks / optimizer_states / lr_schedulers, and the 63-entry
    state_dict (float32 on the CPU), as the JAX package writes it."""
    ckpt = {
        "epoch": int(epoch),
        "global_step": int(global_step),
        "pytorch-lightning_version": "1.5.9",
        "state_dict": {k: v.detach().cpu().clone()
                       for k, v in state_dict.items()},
        "callbacks": {},
        "optimizer_states": [],
        "lr_schedulers": [],
    }
    torch.save(ckpt, str(path))
