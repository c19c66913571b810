"""GATv2 graph modules.

The port of ``gsc_tpu.models.gnn``: an encoder conv, then
``num_layers-1`` process convs applied ``num_iter`` times with shared
weights (each process conv is built once and called ``num_iter`` times),
ReLU between convs, masked mean-pool readout (or, ``pool=False``, the
per-node features).  Single attention head,
self-loops included.  The graph is dense and padded, so attention is a
masked [N, N] softmax over every graph of the batch at once.

``impl``: "dense" runs the plain masked attention; "pallas" runs the fused
attention kernel (``ops.gat_attention``): the CUDA kernel, differentiated
by its backward kernel, on CUDA tensors; its plain version, differentiated
by autograd, on CPU tensors.

``compute_dtype`` (``PrecisionPolicy.gnn_dtype``): None runs the f32 code
verbatim; "bfloat16" projects into bf16 features (``ops.gat.project``) and
runs the attention stage in bf16 (the bf16 kernel on the card), with the
parameters kept as f32 masters and cast at use.  The readout accumulates
in f32 either way.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.gat import attention_dense, dense_adj, project
from ..ops.gat_attention import attention_op
from .init import glorot_uniform_


class GATv2Conv(nn.Module):
    """One GATv2 layer; projections kept as ``nn.Linear`` (weight
    [F, F_in])."""

    def __init__(self, in_features: int, features: int,
                 mean_aggr: bool = True, impl: str = "dense",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if impl not in ("dense", "pallas"):
            raise ValueError(f"unknown GATv2 impl {impl!r}")
        self.in_features = in_features
        self.features = features
        self.mean_aggr = mean_aggr
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.lin_l = nn.utils.skip_init(nn.Linear, in_features, features)
        self.lin_r = nn.utils.skip_init(nn.Linear, in_features, features)
        self.att = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator):
        for lin in (self.lin_l, self.lin_r):
            glorot_uniform_(lin.weight, self.in_features, self.features,
                            generator)
            nn.init.zeros_(lin.bias)
        glorot_uniform_(self.att, self.features, 1, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        xl = project(x, self.lin_l.weight, self.lin_l.bias, cd)
        xr = project(x, self.lin_r.weight, self.lin_r.bias, cd)
        if self.impl == "pallas":
            return attention_op(xl.dtype)(xl, xr, self.att, self.bias, adj,
                                          self.mean_aggr)
        return attention_dense(xl, xr, self.att, self.bias, adj,
                               self.mean_aggr)


def masked_mean_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Mean over real nodes: [..., N, F] -> [..., F], accumulated in f32
    (bf16 activations are widened first; f32 ones are taken as they are)."""
    xf = x.float()
    m = node_mask.to(xf.dtype)[..., None]
    return (xf * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)


class GNNEmbedder(nn.Module):
    """Encoder conv + weight-tied process convs iterated ``num_iter`` times,
    ReLU between convs, masked mean-pool readout; with ``pool=False`` the
    per-node features [..., N, hidden] at the readout point instead (the
    factored heads read node embeddings)."""

    def __init__(self, in_features: int, hidden: int = 22,
                 num_layers: int = 2, num_iter: int = 2,
                 mean_aggr: bool = True, impl: str = "dense",
                 compute_dtype: Optional[str] = None, pool: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.num_iter = num_iter
        self.pool = pool
        self.encoder = GATv2Conv(in_features, hidden, mean_aggr, impl,
                                 compute_dtype)
        self.process = nn.ModuleList(
            GATv2Conv(hidden, hidden, mean_aggr, impl, compute_dtype)
            for _ in range(num_layers - 1))

    def reset_parameters(self, generator: torch.Generator):
        self.encoder.reset_parameters(generator)
        for conv in self.process:
            conv.reset_parameters(generator)

    def forward(self, nodes, edge_index, edge_mask, node_mask):
        adj = dense_adj(edge_index, edge_mask, node_mask)

        def readout(x):
            return masked_mean_pool(x, node_mask) if self.pool else x

        x = torch.relu(self.encoder(nodes, adj))
        if self.num_layers == 1:
            return readout(x)
        for it in range(self.num_iter):
            for i, conv in enumerate(self.process):
                x = conv(x, adj)
                if i == self.num_layers - 2 and it == self.num_iter - 1:
                    return readout(x)
                x = torch.relu(x)
