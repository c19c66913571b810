"""The RL environment over the batched simulator."""
from .actions import (action_mask, action_to_schedule, derive_placement,
                      post_process_action)
from .env import EnvState, ServiceCoordEnv
from .observations import (GraphObs, flat_obs, graph_obs, node_features,
                           obs_map)
from .rewards import compute_reward, reward_constants

__all__ = ["EnvState", "GraphObs", "ServiceCoordEnv", "action_mask",
           "action_to_schedule", "compute_reward", "derive_placement",
           "flat_obs", "graph_obs", "node_features", "obs_map",
           "post_process_action", "reward_constants"]
