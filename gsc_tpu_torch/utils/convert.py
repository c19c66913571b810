"""Carry weights from the JAX package's flax Actor into the port.

``actor_params_from_jax(tree)`` takes the flax ``Actor`` parameter tree as
nested dicts of numpy arrays (``jax.device_get(params)``, with or without
the top-level ``"params"`` key) and returns the port's ``state_dict``:

- a Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``;
- a GATv2 ``w_l``/``w_r [in, F]`` becomes ``lin_l``/``lin_r.weight
  [F, in]`` and ``b_l``/``b_r`` their biases;
- a GATv2 ``att [F, 1]`` becomes ``att [F]``.

It raises on a leaf it does not use and on a leaf the port needs that the
tree lacks.  Nothing here imports JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_CONV_LEAVES = {
    "w_l": ("lin_l.weight", True), "b_l": ("lin_l.bias", False),
    "w_r": ("lin_r.weight", True), "b_r": ("lin_r.bias", False),
    "att": ("att", False), "bias": ("bias", False),
}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _map_leaf(path: tuple) -> Optional[tuple]:
    """flax path -> (port module, port key, transpose) or None when
    unknown."""
    if len(path) == 3 and path[0] == "GNNEmbedder_0" and path[2] in _CONV_LEAVES:
        conv = path[1]
        if conv == "encoder":
            mod = "embedder.encoder"
        else:
            m = re.fullmatch(r"process_(\d+)", conv)
            if m is None:
                return None
            mod = f"embedder.process.{m.group(1)}"
        key, transpose = _CONV_LEAVES[path[2]]
        return mod, f"{mod}.{key}", transpose
    if len(path) == 3 and path[0] == "MLP_0":
        m = re.fullmatch(r"Dense_(\d+)", path[1])
        if m is None or path[2] not in ("kernel", "bias"):
            return None
        mod = f"mlp.layers.{m.group(1)}"
        key = "weight" if path[2] == "kernel" else "bias"
        return mod, f"{mod}.{key}", path[2] == "kernel"
    return None


def actor_params_from_jax(tree: Mapping, actor: Optional[torch.nn.Module] = None
                          ) -> Dict[str, torch.Tensor]:
    """flax Actor params -> the port Actor's ``state_dict``.  With
    ``actor``, the result is also checked key for key and shape for shape
    against ``actor.state_dict()``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    modules = set()
    for path, leaf in _flatten(tree).items():
        mapped = _map_leaf(path)
        if mapped is None:
            raise ValueError(f"unused flax leaf {'/'.join(path)} "
                             f"{leaf.shape}: the port's Actor has no place "
                             "for it")
        mod, key, transpose = mapped
        modules.add(mod)
        arr = leaf.T if transpose else leaf
        if key.endswith(".att"):
            if arr.ndim != 2 or arr.shape[1] != 1:
                raise ValueError(f"flax leaf {'/'.join(path)} is "
                                 f"{leaf.shape}, want [F, 1]")
            arr = arr[:, 0]
        state[key] = torch.tensor(arr, dtype=torch.float32)
    for mod in modules:
        keys = ([k for k, _ in _CONV_LEAVES.values()]
                if mod.startswith("embedder.") else ["weight", "bias"])
        for key in keys:
            if f"{mod}.{key}" not in state:
                raise ValueError(f"flax tree lacks the leaf for {mod}.{key}")
    if actor is not None:
        want = actor.state_dict()
        missing = sorted(set(want) - set(state))
        if missing:
            raise ValueError(f"flax tree lacks leaves for {missing}")
        unused = sorted(set(state) - set(want))
        if unused:
            raise ValueError(f"flax leaves map to {unused}, which the port's "
                             "Actor does not have")
        for k, v in want.items():
            if tuple(v.shape) != tuple(state[k].shape):
                raise ValueError(f"{k}: flax gives {tuple(state[k].shape)}, "
                                 f"the port wants {tuple(v.shape)}")
    return state
