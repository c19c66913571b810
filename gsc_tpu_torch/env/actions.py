"""Action post-processing and placement derivation.

The port of ``gsc_tpu.env.actions``: thresholding and renormalising each
destination row (twice), the flat-action -> schedule reshape, the
reachability placement and the action mask.  Leading dims are batch dims.
"""
from __future__ import annotations

import numpy as np
import torch


def post_process_action(action: torch.Tensor, num_dst: int,
                        threshold: float = 0.1) -> torch.Tensor:
    """Threshold low probabilities to zero and renormalise each destination
    row to sum 1, twice.  An all-zero row becomes uniform over all
    ``num_dst`` (padded) destinations; the second pass zeroes that again
    whenever 1/num_dst < threshold, so the fixed point is uniform.

    action: [..., R * num_dst] flat scheduling tensor in [0, 1].
    """
    shape = action.shape
    rows = action.reshape(shape[:-1] + (-1, num_dst))
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    uniform = torch.full((), 1.0 / num_dst, dtype=rows.dtype,
                         device=rows.device)
    for _ in range(2):
        kept = torch.where(rows >= threshold, rows, zero)
        total = kept.sum(-1, keepdim=True)
        rows = torch.where(total > 0, kept / total.clamp(min=1e-30), uniform)
    return rows.reshape(shape)


def action_to_schedule(action: torch.Tensor, scheduling_shape) -> torch.Tensor:
    """Flat action [..., A] -> dense schedule [..., N, C, S, N]."""
    return action.reshape(action.shape[:-1] + tuple(scheduling_shape))


def derive_placement(schedule: torch.Tensor, chain_sf: np.ndarray,
                     chain_len: np.ndarray, active_ingress: torch.Tensor,
                     num_sfs: int) -> torch.Tensor:
    """Reachability-based placement [..., N, P] from schedule weights.

    Starting from every active ingress, a node hosts SF ``chain_sf[c, s]``
    iff any reachable source schedules nonzero weight to it at chain
    position ``s``; reachability then advances to those targets.

    schedule:       [..., N, C, S, N] scheduling weights
    chain_sf:       [C, S] SF indices (-1 pad)
    chain_len:      [C]
    active_ingress: [..., N] bool
    """
    n = schedule.shape[-4]
    lead = schedule.shape[:-4]
    placed = torch.zeros(lead + (n, num_sfs), dtype=torch.bool,
                         device=schedule.device)
    for c in range(chain_sf.shape[0]):
        reach = active_ingress
        for s in range(int(chain_len[c])):
            targets = ((schedule[..., :, c, s, :] > 0)
                       & reach[..., :, None]).any(dim=-2)
            sf = int(chain_sf[c, s])
            placed[..., sf] = placed[..., sf] | targets
            reach = targets
    return placed


def action_mask(node_mask: torch.Tensor, num_sfcs: int,
                max_sfs: int) -> torch.Tensor:
    """Flattened [..., N*C*S*N] 0/1 mask selecting (real src, *, *, real dst)."""
    m = node_mask.to(torch.float32)
    n = m.shape[-1]
    mask4 = m[..., :, None, None, None] * m[..., None, None, None, :]
    return mask4.expand(m.shape[:-1] + (n, num_sfcs, max_sfs, n)).reshape(
        m.shape[:-1] + (-1,))
