"""GATv2 attention math as plain PyTorch functions.

The port of the f32 paths of ``gsc_tpu.ops.gat``.  GATv2 per directed
edge j->i:
    e_ij   = a^T LeakyReLU_0.2(W_l x_j + W_r x_i)
    alpha  = softmax_j(e_ij) over in-neighbours (self-loop included)
    out_i  = aggr_j(alpha_ij * W_l x_j) + b      (aggr: sum or mean)
Leading dims of every argument are batch dims.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LEAKY_SLOPE = 0.2


def project(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` (``weight`` [F_out, F_in], ``nn.Linear``'s
    layout; the JAX package keeps its transpose)."""
    return F.linear(x, weight, bias)


def dense_adj(edge_index: torch.Tensor, edge_mask: torch.Tensor,
              node_mask: torch.Tensor) -> torch.Tensor:
    """Directed edge list [..., 2, 2E] -> dense [..., N, N] bool adjacency,
    ``adj[i, j]`` = "j is an in-neighbour of i", with self-loops on real
    nodes.  Masked-out edges are dropped."""
    n = node_mask.shape[-1]
    lead = node_mask.shape[:-1]
    ei = edge_index.reshape((-1,) + tuple(edge_index.shape[-2:]))
    em = edge_mask.reshape(-1, edge_mask.shape[-1])
    b = ei.shape[0]
    src = torch.where(em, ei[:, 0], n).long()
    dst = torch.where(em, ei[:, 1], n).long()
    flat = torch.zeros(b, (n + 1) * (n + 1), dtype=torch.bool,
                       device=node_mask.device)
    flat.scatter_(1, dst * (n + 1) + src, True)
    adj = flat.view(b, n + 1, n + 1)[:, :n, :n].reshape(lead + (n, n))
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    return adj | (eye & node_mask[..., :, None])


def attention_dense(xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
                    bias: torch.Tensor, adj: torch.Tensor,
                    mean_aggr: bool) -> torch.Tensor:
    """The attention stage on projected features (xl/xr [..., N, F]):
    masked softmax over in-neighbours, weighted sum of ``xl``, mean by
    degree (after the softmax) when ``mean_aggr``, plus ``bias``.  Rows
    without a neighbour are exactly zero."""
    zero = torch.zeros((), dtype=xl.dtype, device=xl.device)
    e = xl[..., None, :, :] + xr[..., :, None, :]          # [..., i, j, F]
    e = torch.where(e >= 0, e, LEAKY_SLOPE * e)
    logits = torch.einsum("...ijf,f->...ij", e, att)
    logits = torch.where(adj, logits, torch.full((), NEG_INF, device=xl.device))
    mx = logits.amax(dim=-1, keepdim=True)
    ex = torch.where(adj, torch.exp(logits - mx), zero)
    denom = ex.sum(dim=-1, keepdim=True)
    alpha = ex / denom.clamp(min=1e-30)
    out = torch.einsum("...ij,...jf->...if", alpha, xl)
    if mean_aggr:
        deg = adj.sum(dim=-1, keepdim=True)
        out = out / deg.clamp(min=1)
    has_nbr = adj.any(dim=-1, keepdim=True)
    return torch.where(has_nbr, out + bias, zero)
