"""On-device traffic generation: a TrafficSchedule sampled in PyTorch on
the tensors' device.

The port of ``gsc_tpu.sim.traffic_device``.  The host generator
(``traffic.py``) is the reference-parity path; this one samples every
replica's episode on the card, with an explicit ``torch.Generator`` on
that device, so a training run never copies per-episode flow tables from
the host.  The semantics are the host generator's:

- per-ingress renewal arrivals: the first flow at the start of the
  node's first active interval, then ``t += mean`` (deterministic) or
  ``t += Exp(mean)``; the mean is read from the interval that contains
  the emission time;
- a node whose interval is deactivated (trace ``None``) jumps to the
  start of its next active interval without emitting;
- dr ~ N(mean, stdev) with negatives rejected, bounded to 8 redraws and
  then ``|x|``; size deterministic or Pareto(shape) with support >= 1;
  duration = size/dr*1000 ms; TTL, SFC and egress uniform choices;
- the merged stream is sorted by arrival time, ties going to the lowest
  node index, and cut at the schedule's capacity.

Where the JAX package scans one step per flow slot, ``renewal_stream``
steps every (replica, node) clock at once, one control interval per
step: inside one interval a node's mean is fixed, so its emissions there
are its clock plus a cumulative sum of a block of gaps; the first
position past the interval becomes the clock (or the start of the next
active interval, or the end).  A node whose block did not reach the
interval's end continues there in the next step, so the block size
(``J``, from the densest mean) only costs steps, never flows.  The
clocks run in float64, as the host's do.  The candidates of all steps,
node-major, go through one stable sort on time, which gives the host's
tie-break; the flow attributes are then drawn for the ``capacity``
selected rows in one batched call each.

The MMPP chain is sampled on the device per episode; trace overrides,
deactivations, capacity raises and fault tables are deterministic per
scenario and built once on the host into [T, N] tables that stay on the
device.  The random stream differs from the host's (Philox against
numpy's PCG): a device-sampled episode is equal in distribution, and for
fully deterministic configs bit for bit, but seeds do not correspond.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config.schema import ServiceConfig, SimConfig
from ..topology.compiler import Topology
from .state import TrafficSchedule, attach_edge_cap
from .traffic import TraceEvents, traffic_capacity

# rejection draws of one flow's data rate before |x| is taken
DR_REDRAWS = 8
# clock steps between checks that every clock has ended (one sync each)
_END_CHECK = 32


def block_size(cfg: SimConfig, min_mean: float) -> int:
    """Gaps drawn per node and step: an interval's expected emissions at
    the densest mean, plus three standard deviations when random."""
    lam = float(cfg.run_duration) / max(float(min_mean), 1e-9)
    if cfg.deterministic_arrival:
        return int(math.floor(lam)) + 2
    return int(math.ceil(lam + 3.0 * math.sqrt(lam))) + 2


def _floor_div(x: torch.Tensor, d: float) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def renewal_stream(cfg: SimConfig, means: torch.Tensor, active: torch.Tensor,
                   next_active: torch.Tensor, horizon: float, capacity: int,
                   n_sfcs: int, ttl_choices: torch.Tensor,
                   eg_table: torch.Tensor, eg_count: int,
                   generator: torch.Generator, min_mean: float):
    """The renewal merge shared by :class:`DeviceTraffic` and the scenario
    factory: ``means`` (f32/f64, inf where inactive), ``active`` (bool)
    and ``next_active`` (i32/i64, the first active interval at or after
    each one, T for none) are [B, T, N] interval tables on the device;
    ``eg_table`` [eg_count] the egress nodes; ``min_mean`` the smallest
    finite mean (it sizes the gap blocks).  Returns the seven flow-record
    tensors of a TrafficSchedule, each [B, capacity]: times, ingress, dr,
    duration, ttl, sfc, egress."""
    b, steps, n = active.shape
    dev = active.device
    f64 = torch.float64
    rd = float(cfg.run_duration)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    means = means.to(f64)
    next_active = next_active.long()
    bi = torch.arange(b, device=dev)[:, None]
    ni = torch.arange(n, device=dev)[None, :]
    j_n = block_size(cfg, min_mean)
    zero_col = torch.zeros((b, n, 1), dtype=f64, device=dev)

    na0 = next_active[:, 0, :]
    clock = torch.where(na0 < steps, na0.to(f64) * rd, inf)   # [B, N]
    cands = []
    it = 0
    while True:
        if it >= steps and (it - steps) % _END_CHECK == 0 \
                and not bool(torch.isfinite(clock).any()):
            break
        if it > steps + capacity:    # every extra step emits a block
            raise RuntimeError("renewal_stream: clocks did not end")
        it += 1
        fin = torch.isfinite(clock)
        kk = torch.where(fin, _floor_div(clock, rd), torch.zeros_like(clock))
        kk = kk.clamp(0, steps - 1).long()
        mean = means[bi, kk, ni]                               # [B, N]
        if cfg.deterministic_arrival:
            gaps = mean[..., None].expand(b, n, j_n)
        else:
            gaps = mean[..., None] * torch.empty(
                (b, n, j_n), dtype=f64, device=dev).exponential_(
                    generator=generator)
        pos = clock[..., None] + torch.cat([zero_col, gaps.cumsum(-1)], -1)
        inside = (_floor_div(pos, rd) == kk[..., None].to(f64)) \
            & fin[..., None]                                   # [B, N, J+1]
        cands.append(torch.where(inside[..., :j_n], pos[..., :j_n], inf))
        # positions are increasing, so `inside` is a prefix: the first
        # position past the interval is the next clock
        n_in = inside[..., 1:].sum(-1)
        crossed = n_in < j_n
        nxt = pos.gather(-1, (n_in + 1).clamp(max=j_n)[..., None])[..., 0]
        ok = torch.isfinite(nxt)
        k2 = torch.where(ok, _floor_div(nxt, rd), torch.zeros_like(nxt))
        ended = ~ok | (k2 >= steps)
        k2c = k2.clamp(0, steps - 1).long()
        na = next_active[bi, k2c, ni]
        t_jump = torch.where(na < steps, na.to(f64) * rd, inf)
        t_new = torch.where(ended, inf,
                            torch.where(active[bi, k2c, ni], nxt, t_jump))
        clock = torch.where(fin, torch.where(crossed, t_new, nxt), clock)

    # merge: node-major candidates, stable sort on time (ties -> lowest
    # node), the first `capacity` kept
    flat = torch.cat(cands, -1).reshape(b, -1)
    per_node = flat.shape[1] // n
    if flat.shape[1] < capacity:
        flat = torch.cat([flat, inf.expand(b, capacity - flat.shape[1])], -1)
    times, order = torch.sort(flat, dim=-1, stable=True)
    times, order = times[:, :capacity], order[:, :capacity]
    valid = torch.isfinite(times) & (times < horizon)
    node = torch.div(order, per_node, rounding_mode="floor")

    # flow attributes, one batched draw each
    shape = (b, capacity)
    drs = cfg.flow_dr_mean + cfg.flow_dr_stdev * torch.randn(
        shape + (DR_REDRAWS,), dtype=f64, device=dev, generator=generator)
    ok = drs >= 0.0
    first = ok.to(torch.int8).argmax(-1, keepdim=True)
    dr = torch.where(ok.any(-1), drs.gather(-1, first)[..., 0],
                     drs[..., -1].abs())
    if cfg.deterministic_size:
        size = torch.full(shape, float(cfg.flow_size_shape), dtype=f64,
                          device=dev)
    else:
        size = torch.exp(torch.empty(shape, dtype=f64, device=dev)
                         .exponential_(generator=generator)
                         / cfg.flow_size_shape)
    dur = torch.where(dr > 0, size / dr.clamp(min=1e-300) * 1000.0,
                      torch.zeros((), dtype=f64, device=dev))
    ttl = ttl_choices.to(device=dev, dtype=torch.float32)[torch.randint(
        0, ttl_choices.shape[0], shape, device=dev, generator=generator)]
    sfc = torch.randint(0, n_sfcs, shape, device=dev, generator=generator)
    if eg_count:
        eg = eg_table.to(dev)[torch.randint(0, eg_count, shape, device=dev,
                                            generator=generator)]
    else:
        eg = torch.full(shape, -1, device=dev)
    z = lambda dt: torch.zeros((), dtype=dt, device=dev)
    i32, f32 = torch.int32, torch.float32
    return (torch.where(valid, times, inf).to(f32),
            torch.where(valid, node, z(node.dtype)).to(i32),
            torch.where(valid, dr, z(f64)).to(f32),
            torch.where(valid, dur, z(f64)).to(f32),
            torch.where(valid, ttl, z(f32)),
            torch.where(valid, sfc, z(sfc.dtype)).to(i32),
            torch.where(valid, eg, torch.full((), -1, dtype=eg.dtype,
                                              device=dev)).to(i32))


def next_active_table(active: np.ndarray) -> np.ndarray:
    """[T, N] smallest active interval at or after each one (T: none)."""
    steps, n = active.shape
    nxt = np.full((steps + 1, n), steps, np.int64)
    for k in range(steps - 1, -1, -1):
        nxt[k] = np.where(active[k], k, nxt[k + 1])
    return nxt[:steps]


class DeviceTraffic:
    """The traffic sampler of one scenario (config, service, topology,
    trace, faults), built once; ``sample_batch(generator, B)`` draws B
    replicas' episodes on ``device`` (default: the topology's)."""

    def __init__(self, cfg: SimConfig, service: ServiceConfig,
                 topo: Topology, episode_steps: int,
                 trace: Optional[TraceEvents] = None,
                 capacity: Optional[int] = None, faults=(),
                 with_edge_cap: bool = False, device=None):
        dev = torch.device(device) if device is not None \
            else topo.node_cap.device
        n = topo.max_nodes
        steps = episode_steps
        node_mask = topo.node_mask.cpu().numpy()
        node_cap = topo.node_cap.cpu().numpy()
        ing_mask = topo.is_ingress.cpu().numpy() & node_mask
        eg_idx = np.nonzero(topo.is_egress.cpu().numpy() & node_mask)[0]
        ing_idx = np.nonzero(ing_mask)[0]

        # deterministic interval tables, once per scenario
        caps = np.broadcast_to(node_cap, (steps, n)).copy()
        ovr_mask = np.zeros((steps, n), bool)
        ovr_vals = np.full((steps, n), np.inf)
        if trace is not None:
            for (t0, node, mean, cap) in trace.rows:
                k0 = min(int(t0 // cfg.run_duration), steps)
                if node in ing_idx:
                    ovr_mask[k0:, node] = True
                    ovr_vals[k0:, node] = np.inf if mean is None else mean
                if cap is not None:
                    caps[k0:, node] = cap
        edge_cap_t = None
        if faults or with_edge_cap:
            from ..topology.scenarios import apply_faults
            caps, edge_cap_t = apply_faults(topo, caps, steps, faults,
                                            with_edge_cap)
        if cfg.use_states:
            active = np.zeros((steps, n), bool)
            active[:, ing_idx] = True
            base_means = np.full((steps, n), np.inf)
            candidates = [s.inter_arr_mean for s in cfg.states]
        else:
            base_means = np.full((steps, n), np.inf)
            base_means[:, ing_idx] = cfg.inter_arrival_mean
            base_means = np.where(ovr_mask, ovr_vals, base_means)
            active = np.isfinite(base_means)
            candidates = [cfg.inter_arrival_mean]
        active = np.where(ovr_mask, np.isfinite(ovr_vals), active)
        finite = ovr_vals[ovr_mask & np.isfinite(ovr_vals)]
        self.min_mean = float(min(candidates + finite.tolist()))
        self.cfg = cfg
        self.device = dev
        self.episode_steps = steps
        self.capacity = capacity if capacity is not None else \
            traffic_capacity(cfg, len(ing_idx), steps)
        self.horizon = float(steps * cfg.run_duration)
        self.n_sfcs = max(len(service.sfc_names), 1)
        t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
        self.base_means = t(base_means, torch.float64)
        self.active = t(active, torch.bool)
        self.next_active = t(next_active_table(active), torch.int64)
        self.caps = t(caps, torch.float32)
        self.edge_cap_t = None if edge_cap_t is None else \
            edge_cap_t.to(dev)
        self.ovr_mask = t(ovr_mask, torch.bool)
        self.ovr_vals = t(ovr_vals, torch.float64)
        self.ing_mask = t(ing_mask, torch.bool)
        self.ttl_choices = t(cfg.ttl_choices, torch.float32)
        self.eg_table = t(eg_idx, torch.int64)
        self.eg_count = int(len(eg_idx))
        if cfg.use_states:
            self.state_means = [float(s.inter_arr_mean) for s in cfg.states]
            self.switch_p = [float(s.switch_p) for s in cfg.states]
            names = [s.name for s in cfg.states]
            self.init_state = (0 if cfg.init_state is None
                               else names.index(cfg.init_state))

    def _interval_means(self, generator: torch.Generator,
                        batch: int) -> torch.Tensor:
        """[B, T, N] per-interval arrival means (inf: inactive)."""
        steps, n = self.active.shape
        dev = self.device
        if self.cfg.use_states:
            # the two-state chain per ingress, switching at the end of
            # every interval with the current state's probability
            if self.cfg.rand_init_state:
                s = torch.randint(0, 2, (batch, n), device=dev,
                                  generator=generator)
            else:
                s = torch.full((batch, n), self.init_state, device=dev)
            m0, m1, p0, p1 = (torch.tensor(v, dtype=torch.float64,
                                           device=dev)
                              for v in self.state_means + self.switch_p)
            rows = []
            for _ in range(steps):
                rows.append(torch.where(s == 0, m0, m1))
                u = torch.rand((batch, n), dtype=torch.float64, device=dev,
                               generator=generator)
                s = torch.where(u < torch.where(s == 0, p0, p1), 1 - s, s)
            means = torch.stack(rows, 1)
            means = torch.where(self.ing_mask, means, float("inf"))
            means = torch.where(self.ovr_mask, self.ovr_vals, means)
        else:
            means = self.base_means.expand(batch, steps, n)
        return torch.where(self.active, means, float("inf"))

    def sample_batch(self, generator: torch.Generator,
                     num_replicas: int) -> TrafficSchedule:
        """[B]-stacked schedules, one per replica, drawn from
        ``generator`` (on this sampler's device)."""
        b = num_replicas
        steps, n = self.active.shape
        means = self._interval_means(generator, b)
        expand = lambda x: x.expand((b,) + tuple(x.shape))
        rows = renewal_stream(
            self.cfg, means, expand(self.active), expand(self.next_active),
            self.horizon, self.capacity, self.n_sfcs, self.ttl_choices,
            self.eg_table, self.eg_count, generator, self.min_mean)
        times, ingress, drs, durs, ttls, sfcs, egs = rows
        return attach_edge_cap(TrafficSchedule(
            arr_time=times, arr_ingress=ingress, arr_dr=drs,
            arr_duration=durs, arr_ttl=ttls, arr_sfc=sfcs, arr_egress=egs,
            ingress_active=expand(self.active),
            node_cap=expand(self.caps)),
            None if self.edge_cap_t is None else expand(self.edge_cap_t))

    def sample(self, generator: torch.Generator) -> TrafficSchedule:
        """One episode (no batch dim)."""
        return self.sample_batch(generator, 1).map(lambda x: x[0])
