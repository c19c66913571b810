"""gsc_tpu_torch — the PyTorch/CUDA port of gsc_tpu for NVIDIA Hopper.

A package beside ``gsc_tpu`` (the JAX reference), importing ``torch`` and
``numpy`` and nothing of JAX or of ``gsc_tpu``.  It serves the flagship
GATv2 actor and trains it: config, topology, traffic, the batched
simulator engine with the substep megakernel (``ops.substep``), env,
models with the fused attention kernel and its backward kernel
(``ops.gat_attention``; every kernel CUDA C++ in ``csrc/``), the greedy
policy and the micro-batched
server (``serve.run_serve``; ``python -m gsc_tpu_torch.cli serve``), and
replica-parallel DDPG training (``parallel``, ``agents.trainer``;
``python -m gsc_tpu_torch.cli train``).  Entry points run on the card (``device=None`` = ``"cuda"``) and
raise without one unless the caller passes ``device="cpu"``.
"""
from . import (agents, config, env, models, obs, ops, parallel, serve, sim,
               topology, utils)
from .device import resolve_device

__all__ = ["agents", "config", "env", "models", "obs", "ops", "parallel",
           "resolve_device", "serve", "sim", "topology", "utils"]
