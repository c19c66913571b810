"""GATv2 attention: plain PyTorch functions and the CUDA kernel's wrapper
(``ops.gat_attention.gat_attention``)."""
from .gat import LEAKY_SLOPE, NEG_INF, attention_dense, dense_adj, project
from .gat_attention import GatAttention, attention_plain

__all__ = ["GatAttention", "LEAKY_SLOPE", "NEG_INF", "attention_dense",
           "attention_plain", "dense_adj", "project"]
