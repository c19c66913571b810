"""Neural network models: GATv2 embedder and the actor."""
from .gnn import GATv2Conv, GNNEmbedder, masked_mean_pool
from .nets import MLP, Actor

__all__ = ["Actor", "GATv2Conv", "GNNEmbedder", "MLP", "masked_mean_pool"]
