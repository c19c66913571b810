"""Helpers: tensor dataclasses and the flax -> torch weight converter."""
from .convert import (actor_params_from_jax, critic_params_from_jax,
                      learner_state_from_jax, params_from_jax)
from .tree import TensorTree

__all__ = ["TensorTree", "actor_params_from_jax", "critic_params_from_jax",
           "learner_state_from_jax", "params_from_jax"]
