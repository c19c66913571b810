"""GATv2 graph modules.

The port of ``gsc_tpu.models.gnn``: an encoder conv, then
``num_layers-1`` process convs applied ``num_iter`` times with shared
weights (each process conv is built once and called ``num_iter`` times),
ReLU between convs, masked mean-pool readout.  Single attention head,
self-loops included.  The graph is dense and padded, so attention is a
masked [N, N] softmax over every graph of the batch at once.

``impl``: "dense" runs the plain masked attention; "pallas" runs the fused
attention kernel (``ops.gat_attention``): the CUDA kernel on CUDA tensors,
its plain version on CPU tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.gat import attention_dense, dense_adj, project
from ..ops.gat_attention import gat_attention
from .init import glorot_uniform_


class GATv2Conv(nn.Module):
    """One GATv2 layer; projections kept as ``nn.Linear`` (weight
    [F, F_in])."""

    def __init__(self, in_features: int, features: int,
                 mean_aggr: bool = True, impl: str = "dense"):
        super().__init__()
        if impl not in ("dense", "pallas"):
            raise ValueError(f"unknown GATv2 impl {impl!r}")
        self.in_features = in_features
        self.features = features
        self.mean_aggr = mean_aggr
        self.impl = impl
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
        xl = project(x, self.lin_l.weight, self.lin_l.bias)
        xr = project(x, self.lin_r.weight, self.lin_r.bias)
        if self.impl == "pallas":
            return gat_attention(xl, xr, self.att, self.bias, adj,
                                 self.mean_aggr)
        return attention_dense(xl, xr, self.att, self.bias, adj,
                               self.mean_aggr)


def masked_mean_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Mean over real nodes: [..., N, F] -> [..., F]."""
    m = node_mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)


class GNNEmbedder(nn.Module):
    """Encoder conv + weight-tied process convs iterated ``num_iter`` times,
    ReLU between convs, masked mean-pool readout."""

    def __init__(self, in_features: int, hidden: int = 22,
                 num_layers: int = 2, num_iter: int = 2,
                 mean_aggr: bool = True, impl: str = "dense"):
        super().__init__()
        self.num_layers = num_layers
        self.num_iter = num_iter
        self.encoder = GATv2Conv(in_features, hidden, mean_aggr, impl)
        self.process = nn.ModuleList(
            GATv2Conv(hidden, hidden, mean_aggr, impl)
            for _ in range(num_layers - 1))

    def reset_parameters(self, generator: torch.Generator):
        self.encoder.reset_parameters(generator)
        for conv in self.process:
            conv.reset_parameters(generator)

    def forward(self, nodes, edge_index, edge_mask, node_mask):
        adj = dense_adj(edge_index, edge_mask, node_mask)
        x = torch.relu(self.encoder(nodes, adj))
        if self.num_layers == 1:
            return masked_mean_pool(x, node_mask)
        for it in range(self.num_iter):
            for i, conv in enumerate(self.process):
                x = conv(x, adj)
                if i == self.num_layers - 2 and it == self.num_iter - 1:
                    return masked_mean_pool(x, node_mask)
                x = torch.relu(x)
