"""Neural network models: GATv2 embedder, the actor and the critic."""
from .gnn import GATv2Conv, GNNEmbedder, masked_mean_pool
from .nets import MLP, Actor, QNetwork, scale_action, unscale_action

__all__ = ["Actor", "GATv2Conv", "GNNEmbedder", "MLP", "QNetwork",
           "masked_mean_pool", "scale_action", "unscale_action"]
