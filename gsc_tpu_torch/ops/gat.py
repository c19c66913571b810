"""GATv2 attention math as plain PyTorch functions.

The port of ``gsc_tpu.ops.gat``'s dense path.  GATv2 per directed edge
j->i:
    e_ij   = a^T LeakyReLU_0.2(W_l x_j + W_r x_i)
    alpha  = softmax_j(e_ij) over in-neighbours (self-loop included)
    out_i  = aggr_j(alpha_ij * W_l x_j) + b      (aggr: sum or mean)
Leading dims of every argument are batch dims.

Mixed precision (``config.schema.PrecisionPolicy``): ``project`` takes a
``compute_dtype``, and ``attention_dense`` keys its branch on ``xl``'s
dtype, as the JAX package does.  ``None`` and float32 inputs run the f32
code verbatim.  bfloat16 rounds where the JAX package's bf16 branch rounds:
the projections round once after the f32 bias add, the pairwise features
and their LeakyReLU are bf16 (the slope being 0.2 rounded to bf16,
``LEAKY_SLOPE_BF16``, as JAX's weak-typed 0.2 becomes), the logits,
softmax and aggregation accumulate in f32 with the attention weights
rounded to bf16, and the output rounds once to bf16 after the f32 bias.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LEAKY_SLOPE = 0.2
# 0.2 rounded to bfloat16: the slope of the bf16 LeakyReLU
LEAKY_SLOPE_BF16 = 0.2001953125


def compute_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """A policy slot's dtype name ("bfloat16") -> torch dtype; None
    stays None (the f32 code path)."""
    if name is None:
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dt


def project(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            compute_dtype: Optional[str] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` (``weight`` [F_out, F_in], ``nn.Linear``'s
    layout; the JAX package keeps its transpose).  ``None``: the f32
    expression verbatim.  A low-precision ``compute_dtype``: operands
    rounded to it and multiplied in f32 (each product exact, the sum f32),
    the f32 bias added, the result rounded once, as JAX's ``dot_general``
    with ``preferred_element_type=float32`` followed by ``(y + b)``."""
    if compute_dtype is None:
        return F.linear(x, weight, bias)
    cd = compute_dtype_of(compute_dtype)
    y = F.linear(x.to(cd).float(), weight.to(cd).float())
    return (y + bias).to(cd)


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
    without a neighbour are exactly zero.  bf16 ``xl``/``xr`` take the
    bf16 branch (``attention_bf16``, rounded once at the end); any other
    dtype the f32 code."""
    if xl.dtype == torch.bfloat16:
        return attention_bf16(xl, xr, att, bias, adj,
                              mean_aggr).to(torch.bfloat16)
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


def bf16_pairwise(xl: torch.Tensor, xr: torch.Tensor):
    """The bf16 branch's pairwise features: ``e = bf16(xl_j + xr_i)`` and
    ``act = where(e >= 0, e, bf16(LEAKY_SLOPE_BF16 * e))``, both bf16
    [..., i, j, F]; the mask ``e >= 0``."""
    e = xl[..., None, :, :] + xr[..., :, None, :]
    pos = e >= 0
    slope = torch.tensor(LEAKY_SLOPE_BF16, dtype=torch.bfloat16)
    return torch.where(pos, e, e * slope), pos


def attention_bf16(xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
                   bias: torch.Tensor, adj: torch.Tensor, mean_aggr: bool,
                   wide: torch.dtype = torch.float32) -> torch.Tensor:
    """The bf16 branch of ``attention_dense`` on bf16 ``xl``/``xr``,
    returned in ``wide`` before its final rounding: bf16 pairwise
    features (``bf16_pairwise``), logits ``sum_f act * bf16(att)`` and the
    softmax in ``wide``, the weights rounded to bf16, the weighted sum of
    ``xl`` and the mean in ``wide``, plus the ``wide`` bias.  ``wide`` =
    float32 is the plain version of the bf16 forward kernel; float64 gives
    a yardstick with the same rounding points."""
    bf = torch.bfloat16
    act, _ = bf16_pairwise(xl, xr)
    logits = torch.einsum("...ijf,f->...ij", act.to(wide),
                          att.to(bf).to(wide))
    logits = torch.where(adj, logits,
                         torch.full((), NEG_INF, dtype=wide,
                                    device=xl.device))
    mx = logits.amax(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=wide, device=xl.device)
    ex = torch.where(adj, torch.exp(logits - mx), zero)
    denom = ex.sum(dim=-1, keepdim=True)
    alpha = (ex / denom.clamp(min=1e-30)).to(bf).to(wide)
    out = torch.einsum("...ij,...jf->...if", alpha, xl.to(wide))
    if mean_aggr:
        deg = adj.sum(dim=-1, keepdim=True)
        out = out / deg.clamp(min=1)
    has_nbr = adj.any(dim=-1, keepdim=True)
    return torch.where(has_nbr, out + bias.to(wide), zero)
