"""Agents: the DDPG actor and its greedy policy."""
from .ddpg import DDPG

__all__ = ["DDPG"]
