"""Agents: DDPG (actor, critic, learner state), the replay ring and the
replica-parallel trainer."""
from .ddpg import DDPG, DDPGState, Draws

__all__ = ["DDPG", "DDPGState", "Draws"]
