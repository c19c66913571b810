"""Carry weights from the JAX package's flax networks into the port.

``params_from_jax(tree)`` takes a flax ``Actor`` or ``QNetwork`` parameter
tree as nested dicts of numpy arrays (``jax.device_get(params)``, with or
without the top-level ``"params"`` key) and returns the port's
``state_dict`` (``actor_params_from_jax`` and ``critic_params_from_jax``
name it for each network):

- a Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``;
- a GATv2 ``w_l``/``w_r [in, F]`` becomes ``lin_l``/``lin_r.weight
  [F, in]`` and ``b_l``/``b_r`` their biases;
- a GATv2 ``att [F, 1]`` becomes ``att [F]``;
- the factored heads' ``query``, ``key`` (actor) and ``key``, ``src``
  (critic) Dense layers become the port's ``Linear`` layers of the same
  names, and their per-node hidden stack (``MLP_0``) the ``mlp`` as in the
  monolithic heads.

It raises on a leaf it does not use and on a leaf the port needs that the
tree lacks.  ``learner_state_from_jax`` carries a whole DDPG learner state
(both networks, both targets and both Adam states) into a port
``DDPGState``.  Every leaf becomes an f32 master whatever the precision
policy (flax keeps f32 parameters under "bf16" too, and a leaf stored in
another float dtype is widened): the networks cast at use, and no bf16
copy of the weights exists.  Nothing here imports JAX.
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

# the factored heads' dense layers, named as in flax and in the port
_HEAD_DENSE = ("query", "key", "src")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype=np.float32)
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
    if len(path) == 2 and path[0] in _HEAD_DENSE \
            and path[1] in ("kernel", "bias"):
        # the factored heads' dense layers: query and key (actor), key and
        # src (critic)
        key = "weight" if path[1] == "kernel" else "bias"
        return path[0], f"{path[0]}.{key}", path[1] == "kernel"
    if len(path) == 3 and path[0] == "MLP_0":
        m = re.fullmatch(r"Dense_(\d+)", path[1])
        if m is None or path[2] not in ("kernel", "bias"):
            return None
        mod = f"mlp.layers.{m.group(1)}"
        key = "weight" if path[2] == "kernel" else "bias"
        return mod, f"{mod}.{key}", path[2] == "kernel"
    return None


def params_from_jax(tree: Mapping, actor: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """flax Actor or QNetwork params -> the port network's ``state_dict``.
    With a module (``actor``), the result is also checked key for key and
    shape for shape against its ``state_dict()``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    modules = set()
    for path, leaf in _flatten(tree).items():
        mapped = _map_leaf(path)
        if mapped is None:
            raise ValueError(f"unused flax leaf {'/'.join(path)} "
                             f"{leaf.shape}: the port's network has no "
                             "place for it")
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
                             "network does not have")
        for k, v in want.items():
            if tuple(v.shape) != tuple(state[k].shape):
                raise ValueError(f"{k}: flax gives {tuple(state[k].shape)}, "
                                 f"the port wants {tuple(v.shape)}")
    return state


actor_params_from_jax = params_from_jax
critic_params_from_jax = params_from_jax


def learner_state_from_jax(tree: Mapping, state) -> None:
    """Load a JAX ``DDPGState`` into a port ``DDPGState`` in place.

    ``tree`` holds numpy leaves under ``actor_params``, ``critic_params``,
    ``target_actor_params``, ``target_critic_params`` and, for each of
    ``actor_opt`` and ``critic_opt``, optax's Adam state as ``count``,
    ``mu`` and ``nu`` (the moments are laid out like the parameters and
    convert the same way)."""
    nets = (("actor_params", state.actor), ("critic_params", state.critic),
            ("target_actor_params", state.target_actor),
            ("target_critic_params", state.target_critic))
    for key, net in nets:
        sd = params_from_jax(tree[key], net)
        net.load_state_dict(sd)
    for key, net, opt in (("actor_opt", state.actor, state.actor_opt),
                          ("critic_opt", state.critic, state.critic_opt)):
        adam = tree[key]
        mu = params_from_jax(adam["mu"], net)
        nu = params_from_jax(adam["nu"], net)
        step = float(np.asarray(adam["count"]))
        for name, p in net.named_parameters():
            opt.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": mu[name].to(p.device).clone(),
                "exp_avg_sq": nu[name].to(p.device).clone()}
