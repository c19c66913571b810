"""The port's kernels and their plain versions: GATv2 attention
(``ops.gat_attention.gat_attention``, ``gat_attention_bf16``) and its
gradient (``ops.gat_attention.gat_attention_backward``,
``gat_attention_backward_bf16``), and the simulator substep megakernel
(``ops.substep.substep_megakernel``)."""
from .gat import (LEAKY_SLOPE, LEAKY_SLOPE_BF16, NEG_INF, attention_bf16,
                  attention_dense, dense_adj, project)
from .gat_attention import (GatAttention, GatAttentionBackward,
                            attention_backward_plain,
                            attention_backward_wide, attention_op,
                            attention_plain, backward_op)
from .substep import SubstepMegakernel, substep_plain

__all__ = ["GatAttention", "GatAttentionBackward", "LEAKY_SLOPE",
           "LEAKY_SLOPE_BF16", "NEG_INF", "SubstepMegakernel",
           "attention_backward_plain", "attention_backward_wide",
           "attention_bf16", "attention_dense", "attention_op",
           "attention_plain", "backward_op", "dense_adj", "project",
           "substep_plain"]
