"""The port's kernels and their plain versions: GATv2 attention
(``ops.gat_attention.gat_attention``) and its gradient
(``ops.gat_attention.gat_attention_backward``), and the simulator substep
megakernel (``ops.substep.substep_megakernel``)."""
from .gat import LEAKY_SLOPE, NEG_INF, attention_dense, dense_adj, project
from .gat_attention import (GatAttention, GatAttentionBackward,
                            attention_backward_plain, attention_plain)
from .substep import SubstepMegakernel, substep_plain

__all__ = ["GatAttention", "GatAttentionBackward", "LEAKY_SLOPE", "NEG_INF",
           "SubstepMegakernel", "attention_backward_plain", "attention_dense",
           "attention_plain", "dense_adj", "project", "substep_plain"]
