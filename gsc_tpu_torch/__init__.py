"""gsc_tpu_torch — the PyTorch/CUDA port of gsc_tpu for NVIDIA Hopper.

A package beside ``gsc_tpu`` (the JAX reference), importing ``torch`` and
``numpy`` and nothing of JAX or of ``gsc_tpu``.  This slice serves the
flagship GATv2 actor: config, topology, traffic, the batched simulator
engine, env, models with the fused attention kernel
(``ops.gat_attention``, CUDA C++ in ``csrc/``), the greedy policy and the
micro-batched server (``serve.run_serve``; ``python -m gsc_tpu_torch.cli
serve``).  Entry points run on the card (``device=None`` = ``"cuda"``) and
raise without one unless the caller passes ``device="cpu"``.
"""
from . import agents, config, env, models, obs, ops, serve, sim, topology, utils
from .device import resolve_device

__all__ = ["agents", "config", "env", "models", "obs", "ops",
           "resolve_device", "serve", "sim", "topology", "utils"]
