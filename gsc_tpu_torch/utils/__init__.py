"""Helpers: tensor dataclasses, the flax -> torch weight converter and
checkpoints."""
from .checkpoint import (checkpoint_checksum, checkpoint_precision,
                         load_checkpoint, load_full_or_partial,
                         read_checkpoint_meta, save_checkpoint,
                         verify_checkpoint)
from .convert import (actor_params_from_jax, critic_params_from_jax,
                      learner_state_from_jax, params_from_jax)
from .tree import TensorTree

__all__ = ["TensorTree", "actor_params_from_jax", "checkpoint_checksum",
           "checkpoint_precision", "critic_params_from_jax",
           "learner_state_from_jax", "load_checkpoint",
           "load_full_or_partial", "params_from_jax",
           "read_checkpoint_meta", "save_checkpoint", "verify_checkpoint"]
