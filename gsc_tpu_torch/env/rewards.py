"""Reward objectives.

The port of ``gsc_tpu.env.rewards``: ``prio-flow``, ``soft-deadline``,
``soft-deadline-exp`` and ``weighted``, over batched metrics ([B]
counters, [B, N, P] placement).

Components (all in [-1, 1]):
- flow reward (succ - drop)/(succ + drop) over the last control interval;
- delay reward 1 + (min_delay - delay)/diameter, clipped; -1 when no flow
  succeeded; min_delay = sum of VNF processing means, diameter 15;
- shaped node reward counting a used node as 0.5..1 by its placed SFs;
- instance reward by total placed instances.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config.schema import AgentConfig


def reward_constants(agent: AgentConfig, proc_delay_means) -> Tuple[float, float]:
    """(min_delay, network_diameter)."""
    return float(sum(proc_delay_means)), 15.0


def compute_reward(agent: AgentConfig, metrics, placement: torch.Tensor,
                   node_mask: torch.Tensor, num_sfs: int, min_delay: float,
                   diameter: float, ewma_flows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total_reward, new_ewma_flows, info); ``placement`` is the derived
    [..., N, P] placement."""
    dev = ewma_flows.device
    zero = torch.zeros((), device=dev)
    succ = metrics.run_processed.to(torch.float32)
    drop = metrics.run_dropped.to(torch.float32)
    total = succ + drop
    succ_ratio = torch.where(total > 0, succ / total.clamp(min=1.0), zero)
    flow_reward = torch.where(total > 0, (succ - drop) / total.clamp(min=1.0),
                              zero)

    delay = torch.clamp(metrics.run_avg_e2e(), min=min_delay)
    delay_reward = torch.clamp((min_delay - delay) / diameter + 1.0, -1.0, 1.0)
    delay_reward = torch.where(succ_ratio == 0, -1.0, delay_reward)

    num_nodes = node_mask.sum(-1).to(torch.float32)
    k = placement.to(torch.float32).sum(dim=-1)
    frac = torch.where(
        k > 0, 0.5 + 0.5 * (k - 1.0) / max(num_sfs - 1.0, 1.0), zero)
    nodes_used = torch.where(node_mask, frac, zero).sum(-1)
    nodes_reward = 2.0 * (-nodes_used / num_nodes.clamp(min=1.0)) + 1.0

    num_instances = placement.to(torch.float32).sum(dim=(-1, -2))
    instance_reward = 2.0 * (-num_instances
                             / (num_nodes * num_sfs).clamp(min=1.0)) + 1.0

    new_ewma = ewma_flows
    if agent.objective == "prio-flow":
        nodes_reward = torch.zeros_like(succ)
        instance_reward = torch.zeros_like(succ)
        if agent.target_success == "auto":
            target = 0.9 * ewma_flows
            new_ewma = 0.5 * succ_ratio + 0.5 * ewma_flows
        else:
            target = torch.full_like(succ, float(agent.target_success))
        delay_reward = torch.where(succ_ratio < target, -1.0, delay_reward)
    elif agent.objective == "soft-deadline":
        nodes_reward = torch.zeros_like(succ)
        instance_reward = torch.zeros_like(succ)
        met = delay <= agent.soft_deadline
        flow_reward = torch.where(met, flow_reward, -1.0)
        delay_reward = torch.where(
            met, min(max(-agent.soft_deadline / diameter, -1.0), 1.0),
            delay_reward)
    elif agent.objective == "soft-deadline-exp":
        flow_reward = torch.zeros_like(succ)
        nodes_reward = torch.zeros_like(succ)
        instance_reward = torch.zeros_like(succ)
        over = torch.clamp(delay - agent.soft_deadline, min=1e-30)
        delay_utility = torch.where(
            delay > agent.soft_deadline,
            torch.clamp(-torch.log10(over / agent.dropoff), 0.0, 1.0),
            torch.ones((), device=dev))
        delay_reward = succ_ratio * delay_utility
    elif agent.objective == "weighted":
        flow_reward = flow_reward * agent.flow_weight
        delay_reward = delay_reward * agent.delay_weight
        nodes_reward = nodes_reward * agent.node_weight
        instance_reward = instance_reward * agent.instance_weight

    total_reward = flow_reward + delay_reward + nodes_reward + instance_reward
    info = {
        "succ_ratio": succ_ratio,
        "avg_e2e_delay": delay,
        "flow_reward": flow_reward,
        "delay_reward": delay_reward,
        "nodes_reward": nodes_reward,
        "instance_reward": instance_reward,
    }
    return total_reward, new_ewma, info
