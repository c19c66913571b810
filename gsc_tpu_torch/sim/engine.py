"""Batched fixed-step flow simulation engine (duration controller).

The port of ``gsc_tpu.sim.engine``: ``ServiceTables``, ``SimEngine.init``
/ ``apply`` and the substep of ``SimEngine._substep_xla``.  An interval
runs through the substep megakernel (``ops.substep``): one CUDA launch per
interval on the card, this module's plain substep on the CPU, whichever
``SimConfig.substep_impl`` a configuration names.  One control
interval (= one RL step, ``run_duration`` ms) is a Python loop over
``run_duration/dt`` fixed substeps; each substep advances every flow slot
of every replica in parallel.  Every tensor carries a leading [B] dim of
env replicas.

Per-substep pipeline:
 1. release capacities whose hold time elapsed (ring buffers);
 2. advance HOP/PROC timers; finished processing advances the chain
    position, finished hops continue the path, arrive for processing or
    depart at egress;
 3. admit new arrivals from the TrafficSchedule into free slots;
 4. decisions: egress routing for finished flows and weighted-round-robin
    next-node selection against the schedule, with same-substep
    collisions in one cell serialised over ``wrr_rank_levels`` rounds;
 5. forwarding: upfront whole-path TTL check, then hop-by-hop traversal
    with per-edge capacity admission in slot order;
 6. processing: placement check, processing delay with TTL check, node
    capacity admission through the per-SF resource functions, startup
    wait, delayed load release;
 7. departures and drops with the 4-reason taxonomy.

Where the JAX package moves data with one-hot contractions (exact under
``Precision.HIGHEST``), the port gathers and scatters: out-of-range rows
give zeros as the one-hot rows did.  ``jnp.mod`` is ``torch.remainder``,
``jnp.round`` and ``torch.round`` both round half to even, and the
grouping argsort sorts unique keys, so its order needs no stability.
Float sums over flows (the admission cumsums, the scatter-adds, the
whole-slot sums) may add in another order than XLA does, so they agree
bit for bit only where the traffic is integer-valued.  The whole-slot sums
add in slot order (``slot_order_sum``), as kernel #2 does.

Randomness: the processing-delay noise comes in from outside (``noise``,
or drawn from a ``torch.Generator``), the same way the JAX package's
megakernel path draws it outside its kernel.  Deterministic processing
delays (every SF with stdev 0, the abc catalog) need none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config.registry import get_resource_function
from ..config.schema import EnvLimits, ServiceConfig, SimConfig
from ..topology.compiler import Topology
from .state import (DROP_DECISION, DROP_LINK_CAP, DROP_NODE_CAP, DROP_TTL,
                    PH_DECIDE, PH_FREE, PH_HOP, PH_PROC, FlowTable,
                    SimMetrics, SimState, TrafficSchedule, init_state)

_EPS = 1e-4
# arrivals admitted per substep; later arrivals spill to the next substep
_ARRIVALS_PER_SUBSTEP = 8
_I32 = torch.int32


@dataclass(frozen=True)
class ServiceTables:
    """Static per-service tables derived from ServiceConfig."""

    chain_sf: np.ndarray      # [C, S_pos] i32 SF id per chain position (-1 pad)
    chain_len: np.ndarray     # [C] i32
    proc_mean: np.ndarray     # [P] f32
    proc_std: np.ndarray      # [P] f32
    startup_delay: np.ndarray  # [P] f32
    resource_fns: Tuple[Callable, ...]  # per SF id

    @classmethod
    def build(cls, service: ServiceConfig, limits: EnvLimits) -> "ServiceTables":
        sf_names = list(service.sf_names)
        s = limits.max_sfs
        c = limits.num_sfcs
        pool = limits.sf_pool
        if len(sf_names) > pool:
            raise ValueError(
                f"SF catalog has {len(sf_names)} SFs but limits.sf_pool is "
                f"{pool}; set EnvLimits.num_sfs (EnvLimits.for_service does)")
        chain_sf = np.full((c, s), -1, np.int32)
        chain_len = np.zeros(c, np.int32)
        for ci, name in enumerate(service.sfc_names):
            chain = service.sfc_list[name]
            chain_len[ci] = len(chain)
            for si, sf in enumerate(chain):
                chain_sf[ci, si] = sf_names.index(sf)
        proc_mean = np.zeros(pool, np.float32)
        proc_std = np.zeros(pool, np.float32)
        startup = np.zeros(pool, np.float32)
        fns = []
        for i, name in enumerate(sf_names[:pool]):
            sf = service.sf_list[name]
            proc_mean[i] = sf.processing_delay_mean
            proc_std[i] = sf.processing_delay_stdev
            startup[i] = sf.startup_delay
            fns.append(get_resource_function(sf.resource_function_id))
        while len(fns) < pool:
            fns.append(get_resource_function("default"))
        return cls(chain_sf=chain_sf, chain_len=chain_len, proc_mean=proc_mean,
                   proc_std=proc_std, startup_delay=startup,
                   resource_fns=tuple(fns))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, 1] batch-row index for advanced indexing."""
    return torch.arange(x.shape[0], device=x.device)[:, None]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b, m]]``: table [B, n, ...], idx [B, M] -> [B, M, ...].
    Out-of-range indices give zero (False) rows."""
    n = table.shape[1]
    valid = (idx >= 0) & (idx < n)
    out = table[_rows(idx), idx.clamp(0, n - 1).long()]
    valid = valid.view(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


def _take2(table: torch.Tensor, i: torch.Tensor,
           j: torch.Tensor) -> torch.Tensor:
    """``table[b, i, j]`` for table [B, n, k] and i, j [B, M]; zero where
    either index is out of range."""
    n, k = table.shape[1], table.shape[2]
    valid = (i >= 0) & (i < n) & (j >= 0) & (j < k)
    out = table[_rows(i), i.clamp(0, n - 1).long(), j.clamp(0, k - 1).long()]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


def _scatter_add(target: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``target[b, idx[b, m]] += vals[b, m]`` with out-of-range indices
    dropped; target [B, n] or [B, n, k] (vals then [B, M, k])."""
    n = target.shape[1]
    ok = (idx >= 0) & (idx < n)
    ix = torch.where(ok, idx, torch.full_like(idx, n)).long()
    pad = torch.zeros((target.shape[0], 1) + tuple(target.shape[2:]),
                      dtype=target.dtype, device=target.device)
    buf = torch.cat([target, pad], dim=1)
    if target.dim() == 3:
        ix = ix[:, :, None].expand(-1, -1, target.shape[2])
    return buf.scatter_add(1, ix, vals.to(target.dtype))[:, :n]


def slot_order_sum(vals: torch.Tensor) -> torch.Tensor:
    """``vals`` [..., M] f32 summed over the slots in slot order from +0,
    each addition rounded to f32: how kernel #2 adds the whole-slot sums
    (path credits, processing delays, departures' end-to-end delays), so
    the two agree bit for bit where a vectorised ``sum`` would add
    fractional terms in another order.  numpy's ``add.accumulate`` is
    that sequential sum, on the host."""
    v = vals.detach().cpu().numpy()
    v = np.concatenate([np.zeros(v.shape[:-1] + (1,), np.float32), v], -1)
    acc = np.add.accumulate(v, axis=-1, dtype=np.float32)[..., -1]
    return torch.from_numpy(np.ascontiguousarray(acc)).to(vals.device)


def _group_order(key: torch.Tensor) -> torch.Tensor:
    """Permutation sorting flows by (key, slot): keys made unique with the
    slot index, so no stability assumption is needed.  key [B, M]."""
    m = key.shape[1]
    slots = torch.arange(m, device=key.device)
    return torch.argsort(key.long() * m + slots, dim=1)


def _run_starts(sorted_key: torch.Tensor) -> torch.Tensor:
    """For each sorted position, the first position of its key's run."""
    b, m = sorted_key.shape
    idx = torch.arange(m, device=sorted_key.device).expand(b, m)
    new = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                device=sorted_key.device),
                     sorted_key[:, 1:] != sorted_key[:, :-1]], dim=1)
    return torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                        dim=1).values


def _rank_in_cell(cell: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rank[m] = #(flows m' < m with mask and the same cell); meaningful
    under ``mask`` only."""
    m = cell.shape[1]
    same = (cell[:, :, None] == cell[:, None, :]) & mask[:, None, :]
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=cell.device).tril(diagonal=-1)
    return (same & earlier).sum(-1).to(_I32)


class SimEngine:
    """Engine closing over static config.

    ``init(batch, device)`` -> SimState of ``batch`` empty replicas.
    ``apply(state, topo, traffic, schedule, placement)`` -> (state', metrics)
    runs one control interval.  ``topo`` and ``traffic`` are shared by all
    replicas or carry a leading [B]; ``schedule`` [B, N, C, S, N] and
    ``placement`` [B, N, P].
    """

    def __init__(self, service: ServiceConfig, cfg: SimConfig,
                 limits: EnvLimits):
        self.service = service
        self.cfg = cfg
        self.limits = limits
        self.tables = ServiceTables.build(service, limits)
        self.substeps = cfg.substeps_per_run
        self.dt = cfg.dt
        self.M = cfg.max_flows
        self.H = cfg.release_horizon
        self.N = limits.max_nodes
        self.C = limits.num_sfcs
        self.S = limits.max_sfs     # chain-position axis (schedule tensor)
        self.P = limits.sf_pool     # SF-id axis (placement/load/proc tables)
        self.E = limits.max_edges
        if cfg.run_duration > (self.H - 1) * self.dt:
            raise ValueError("release_horizon must cover at least one run_duration")
        self.det_proc = float(np.max(self.tables.proc_std)) == 0.0
        self._dev_tables = {}

    def _tab(self, device) -> dict:
        """The service tables as tensors on ``device`` (built once)."""
        key = str(device)
        tabs = self._dev_tables.get(key)
        if tabs is None:
            t = self.tables
            f = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
            tabs = self._dev_tables[key] = {
                "chain_len": f(t.chain_len, _I32),
                "chain_sf": f(t.chain_sf.reshape(-1), _I32),
                "proc": f(np.stack([t.proc_mean, t.proc_std,
                                    t.startup_delay], axis=-1), torch.float32),
            }
        return tabs

    def init(self, batch: int, device) -> SimState:
        return init_state(batch, self.M, self.N, self.C, self.S, self.E,
                          self.H, p=self.P, device=device)

    def _demanded(self, load_plus: torch.Tensor,
                  avail: torch.Tensor) -> torch.Tensor:
        """Total demanded node capacity from per-SF loads [..., P] summed
        over available SFs through the per-SF resource functions."""
        cols = [torch.where(avail[..., s], fn(load_plus[..., s]),
                            torch.zeros((), device=load_plus.device))
                for s, fn in enumerate(self.tables.resource_fns)]
        return torch.stack(cols, dim=-1).sum(dim=-1)

    def draw_noise(self, batch: int, generator: torch.Generator,
                   device) -> Optional[torch.Tensor]:
        """Standard-normal processing-delay noise [B, substeps, M] for one
        interval, or None when every processing delay is deterministic."""
        if self.det_proc:
            return None
        z = torch.randn((batch, self.substeps, self.M), generator=generator,
                        device=generator.device)
        return z.to(device)

    # ------------------------------------------------------------- one interval
    def apply(self, state: SimState, topo: Topology, traffic: TrafficSchedule,
              schedule: torch.Tensor, placement: torch.Tensor,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[SimState, SimMetrics]:
        if not self.det_proc and noise is None:
            raise ValueError("stochastic processing delays need noise "
                             "[B, substeps, M] (see draw_noise)")
        b = state.batch
        topo = topo.expand(b)
        traffic = traffic.expand(b)
        state, cap_now = self.begin_interval(state, traffic, schedule,
                                             placement)
        # the megakernel: one launch for the interval on the card, the
        # plain substep repeated on the CPU (whatever ``substep_impl`` says)
        from ..ops.substep import substep_megakernel
        state = substep_megakernel(self, state, topo, traffic, cap_now, noise)
        state = state.replace(run_idx=state.run_idx + 1)
        return state, state.metrics

    def begin_interval(self, state: SimState, traffic: TrafficSchedule,
                       schedule: torch.Tensor, placement: torch.Tensor
                       ) -> Tuple[SimState, torch.Tensor]:
        """The action's effect at the start of an interval (placement,
        schedule, newly available SFs, run-metric reset) and this
        interval's node capacities ``cap_now`` [B, N]; ``traffic`` carries
        the batch dim."""
        b = state.batch
        available = placement | (state.node_load > _EPS)
        newly = available & ~state.sf_available
        tt = state.t[:, None, None]
        state = state.replace(
            placed=placement, schedule=schedule, sf_available=available,
            sf_startup=torch.where(newly, tt, state.sf_startup),
            sf_last_active=torch.where(newly, tt, state.sf_last_active),
            metrics=state.metrics.reset_run())
        t_steps = traffic.node_cap.shape[1]
        idx_now = state.run_idx.clamp(0, t_steps - 1).long()
        cap_now = traffic.node_cap[torch.arange(b, device=idx_now.device),
                                  idx_now]                 # [B, N]
        return state, cap_now

    # ---------------------------------------------------------------- substep
    def substep(self, state: SimState, topo: Topology,
                traffic: TrafficSchedule, cap_now: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> SimState:
        """One substep of every replica.  ``topo``/``traffic`` carry the
        batch dim (``expand``); ``noise`` [B, M] or None."""
        F = state.flows
        m = state.metrics
        dev = state.t.device
        dt = self.dt
        B, M, N, C, S, P, E, H = (state.batch, self.M, self.N, self.C,
                                  self.S, self.P, self.E, self.H)
        tab = self._tab(dev)
        t = state.t
        zero = torch.zeros((), device=dev)
        bi = torch.arange(B, device=dev)
        g = torch.round(t / dt).to(_I32)            # global substep index
        ridx = torch.remainder(g, H).long()         # ring-buffer index

        # --- 1. capacity releases ------------------------------------------
        node_load = torch.clamp(
            state.node_load - state.rel_node[bi, ridx].view(B, N, P), min=0.0)
        edge_used = torch.clamp(state.edge_used - state.rel_edge[bi, ridx],
                                min=0.0)
        rel_node = state.rel_node.clone()
        rel_edge = state.rel_edge.clone()
        rel_node[bi, ridx] = 0.0
        rel_edge[bi, ridx] = 0.0
        # graceful SF removal once drained and unplaced
        sf_available = state.sf_available & (state.placed | (node_load > _EPS))

        # --- 2. timers ------------------------------------------------------
        running = (F.phase == PH_HOP) | (F.phase == PH_PROC)
        timer = torch.where(running, F.timer - dt, F.timer)
        proc_done = (F.phase == PH_PROC) & (timer <= _EPS)
        hop_done = (F.phase == PH_HOP) & (timer <= _EPS)
        position = F.position + proc_done.to(_I32)
        phase = torch.where(proc_done, PH_DECIDE, F.phase)

        node = torch.where(hop_done, F.hop_next, F.node)
        arrived = hop_done & (node == F.dest)
        cont = hop_done & ~arrived                 # continue multi-hop path
        path_cred = torch.where(arrived, F.pend_path, zero)
        e2e = F.e2e + path_cred
        ttl = F.ttl - path_cred
        n_arr = arrived.sum(-1, dtype=_I32)
        # (the path credits' sum joins the metrics at step 7)
        m = m.replace(num_path_delay=m.num_path_delay + n_arr)
        chain_len_tab = tab["chain_len"].expand(B, C)
        # an out-of-range SFC id reads chain_len 0 and heads to egress
        chain_len = _take(chain_len_tab, F.sfc)
        to_eg_flag = position >= chain_len
        depart_hop = arrived & to_eg_flag
        need_proc_a = arrived & ~to_eg_flag

        # --- 3. arrivals ----------------------------------------------------
        A = _ARRIVALS_PER_SUBSTEP
        cap_f = traffic.capacity
        cand = state.cursor[:, None] + torch.arange(A, device=dev, dtype=_I32)
        cand_c = cand.clamp(0, cap_f - 1).long()
        arr = lambda field: torch.gather(field, 1, cand_c)
        a_time = arr(traffic.arr_time)
        due = (a_time < (t + dt - _EPS)[:, None]) & (cand < cap_f) \
            & torch.isfinite(a_time)
        free = phase == PH_FREE
        free_rank = torch.cumsum(free.to(_I32), dim=1) - 1
        n_free = free.sum(-1)
        arr_rank = torch.cumsum(due.to(_I32), dim=1) - 1
        spawn = due & (arr_rank < n_free[:, None])
        # slot_of_rank[r] = slot index of the r-th free slot (0 if none)
        slots = torch.arange(M, device=dev, dtype=_I32).expand(B, M)
        slot_of_rank = torch.zeros(B, M + 1, dtype=_I32, device=dev).scatter(
            1, torch.where(free, free_rank, M).long(), slots)[:, :M]
        tgt = torch.gather(slot_of_rank, 1, arr_rank.clamp(0, M - 1).long())
        arr_idx = torch.where(spawn, tgt, M).long()

        def put(cur, new):
            buf = torch.cat([cur, cur[:, :1]], dim=1)
            return buf.scatter(1, arr_idx, new.to(cur.dtype))[:, :M]

        a_i32 = torch.zeros_like(cand)
        a_ing = arr(traffic.arr_ingress)
        a_dr = arr(traffic.arr_dr)
        phase = put(phase, a_i32 + PH_DECIDE)
        node = put(node, a_ing)
        position = put(position, a_i32)
        sfc = put(F.sfc, arr(traffic.arr_sfc))
        egress = put(F.egress, arr(traffic.arr_egress))
        dest = put(F.dest, a_i32 - 1)
        dr = put(F.dr, a_dr)
        duration = put(F.duration, arr(traffic.arr_duration))
        ttl = put(ttl, arr(traffic.arr_ttl))
        e2e = put(e2e, torch.zeros_like(a_dr))
        pend_path = put(F.pend_path, torch.zeros_like(a_dr))
        hop_next = F.hop_next
        n_spawn = spawn.sum(-1, dtype=_I32)
        cursor = state.cursor + n_spawn
        # arrivals spawning after their scheduled substep were delayed by
        # slot exhaustion or the per-substep arrival budget
        late = spawn & (a_time < (t - _EPS)[:, None])
        truncated = state.truncated_arrivals + late.sum(-1, dtype=_I32)
        m = m.replace(
            generated=m.generated + n_spawn,
            run_generated=m.run_generated + n_spawn,
            active=m.active + n_spawn,
            run_requested_node=_scatter_add(
                m.run_requested_node, torch.where(spawn, a_ing, N),
                torch.where(spawn, a_dr, zero)))

        sfc_c = sfc.clamp(0, C - 1)
        chain_len = _take(chain_len_tab, sfc)
        to_eg_flag = position >= chain_len

        # --- 4. decisions ---------------------------------------------------
        deciding = phase == PH_DECIDE
        # TTL exhausted at decision time -> drop
        drop_ttl0 = deciding & (ttl <= _EPS)
        decide = deciding & ~drop_ttl0
        to_eg = decide & to_eg_flag
        # flows with no egress depart at their current node
        egress = torch.where(to_eg & (egress < 0), node, egress)
        wrr = decide & ~to_eg_flag

        sf_pos = position.clamp(0, S - 1)
        sf_now = _take(tab["chain_sf"].expand(B, C * S),
                       sfc_c * S + sf_pos).clamp(min=0)
        cell = (node * C + sfc_c) * S + sf_pos      # (node, sfc, sf_pos)
        ncs = N * C * S
        # requested traffic of every WRR decision, before the schedule lookup
        req_add = _scatter_add(
            torch.zeros(B, ncs, device=dev), cell,
            torch.where(wrr, dr, zero)).view(B, N, C, S)
        m = m.replace(run_requested=m.run_requested + req_add)

        # WRR over the schedule row with realized-ratio counters;
        # same-cell same-substep collisions run in slot-order rounds so
        # later flows see the updated counters
        rank = _rank_in_cell(cell, wrr)
        flow_counts = m.run_flow_counts.reshape(B, ncs, N)
        probs = _take(state.schedule.reshape(B, ncs, N), cell)
        R = self.cfg.wrr_rank_levels
        for r in range(R):
            sel = wrr & ((rank == r) if r < R - 1 else (rank >= r))
            counts = _take(flow_counts, cell)
            total = counts.sum(-1, keepdim=True)
            ratios = torch.where(total > 0, counts / total.clamp(min=1), zero)
            diffs = torch.where(probs > 0, probs - ratios,
                                torch.tensor(-1.0, device=dev))
            choice = torch.argmax(diffs, dim=-1).to(_I32)
            dest = torch.where(sel, choice, dest)
            flow_counts = _scatter_add(
                flow_counts.reshape(B, ncs * N), cell * N + choice,
                sel.to(_I32)).view(B, ncs, N)
        m = m.replace(run_flow_counts=flow_counts.view(B, N, C, S, N))
        dest = torch.where(to_eg, egress, dest)

        # --- 5. forwarding --------------------------------------------------
        fwd = decide
        stay = fwd & (dest == node)
        depart_stay = to_eg & stay
        need_proc_b = wrr & stay
        start_path = fwd & ~stay
        dest_c = dest.clamp(min=0)
        pd_tab = torch.where(torch.isfinite(topo.path_delay), topo.path_delay,
                             torch.tensor(1e30, device=dev))
        pd_path = _take2(pd_tab, node, dest_c)
        cap_mine = _take(cap_now, node)
        # upfront whole-path TTL check; unreachable destinations drop too
        drop_ttl_path = start_path & (ttl - pd_path <= _EPS)
        ttl = torch.where(drop_ttl_path, zero, ttl)
        start_path = start_path & ~drop_ttl_path

        # hop starts this substep: fresh paths + mid-path continuations
        hop_req = cont | start_path
        nh = _take2(topo.next_hop, node, dest_c).clamp(min=0)
        eid = _take2(topo.adj_edge_id, node, nh)
        eid_c = eid.clamp(min=0)
        edge_rows = _take(torch.stack(
            [topo.edge_cap - edge_used + _EPS, topo.edge_delay], dim=-1), eid_c)
        headroom = edge_rows[..., 0]

        need_proc = need_proc_a | need_proc_b
        sf_ok = _take2(state.placed.reshape(B, N, P), node, sf_now)
        # SF not in placement -> drop (NODE_CAP)
        drop_unplaced = need_proc & ~sf_ok
        want = need_proc & sf_ok
        proc_tab = _take(tab["proc"].expand(B, P, 3), sf_now)
        pmean = proc_tab[..., 0]
        if self.det_proc:
            pdel = torch.abs(pmean)
        else:
            pdel = torch.abs(noise * proc_tab[..., 1] + pmean)
        # TTL check before the delay is credited
        drop_ttl_pd = want & (ttl - pdel <= _EPS)
        want = want & ~drop_ttl_pd

        # link admission, greedy in slot order within each edge's group
        order_e = _group_order(eid_c)
        perm = lambda x, o: torch.gather(x, 1, o)
        eid_s = perm(eid_c, order_e)
        req_s = perm(hop_req & (eid >= 0), order_e)
        dr_s = perm(dr, order_e)
        headroom_s = perm(headroom, order_e)
        starts_e = _run_starts(eid_s)
        adm_s = req_s
        for _ in range(self.cfg.admission_iters):
            v = torch.where(adm_s, dr_s, zero)
            cs = torch.cumsum(v, dim=1)
            adm_s = req_s & (cs - (perm(cs, starts_e) - perm(v, starts_e))
                             <= headroom_s)
        admitted = torch.zeros_like(adm_s).scatter(1, order_e, adm_s)
        drop_link = hop_req & ~admitted
        add_e = torch.where(admitted, dr, zero)
        edge_add = _scatter_add(torch.zeros(B, E, device=dev), eid_c, add_e)
        edge_used = edge_used + edge_add
        m = m.replace(run_passed_traffic=m.run_passed_traffic + edge_add)
        hop_delay = edge_rows[..., 1]
        # release link capacity hop_delay + duration after the hop starts
        off_e = torch.clamp(torch.ceil((hop_delay + duration) / dt).to(_I32),
                            1, H - 1)
        h_e = torch.where(admitted, torch.remainder(ridx[:, None] + off_e, H),
                          H)
        rel_edge = _scatter_add(rel_edge.view(B, H * E),
                                torch.where(admitted, h_e * E + eid_c, H * E),
                                add_e).view(B, H, E)
        pend_path = torch.where(start_path & admitted, pd_path, pend_path)
        hop_next = torch.where(admitted, nh, hop_next)
        timer = torch.where(admitted, hop_delay, timer)
        phase = torch.where(admitted, PH_HOP, phase)

        # --- 6. processing --------------------------------------------------
        ttl = torch.where(drop_ttl_pd, zero, ttl)
        pdel_w = torch.where(want, pdel, zero)
        e2e = e2e + pdel_w
        ttl = ttl - pdel_w
        m = m.replace(
            num_proc_delay=m.num_proc_delay + want.sum(-1, dtype=_I32))
        # node capacity admission through the resource functions, greedy in
        # slot order within each node's group
        order_n = _group_order(node)
        node_s = perm(node, order_n)
        want_s = perm(want, order_n)
        dr_col_s = perm(dr, order_n)[..., None]
        cap_s = perm(cap_mine, order_n)
        starts_n = _run_starts(node_s)
        base_load_s = _take(node_load, node_s)
        avail_s = _take(sf_available, node_s)
        sf_onehot_s = perm(sf_now, order_n)[..., None] == torch.arange(
            P, device=dev)
        st3 = starts_n[..., None].expand(B, M, P)
        adm_ns = want_s
        dem_s = torch.zeros(B, M, device=dev)
        for _ in range(self.cfg.admission_iters):
            v = torch.where(adm_ns[..., None] & sf_onehot_s, dr_col_s, zero)
            cs = torch.cumsum(v, dim=1)
            dem_s = self._demanded(
                base_load_s + cs - (torch.gather(cs, 1, st3)
                                    - torch.gather(v, 1, st3)), avail_s)
            adm_ns = want_s & (dem_s <= cap_s + _EPS)
        admitted_n = torch.zeros_like(adm_ns).scatter(1, order_n, adm_ns)
        demanded = torch.zeros_like(dem_s).scatter(1, order_n, dem_s)
        drop_nodecap = want & ~admitted_n
        add_n = torch.where(admitted_n, dr, zero)
        node_add = _scatter_add(torch.zeros(B, N * P, device=dev),
                                node * P + sf_now, add_n).view(B, N, P)
        node_load = node_load + node_add
        usage = torch.zeros(B, N, device=dev).scatter_reduce(
            1, node.long(), torch.where(admitted_n, demanded, zero), "amax",
            include_self=True)
        m = m.replace(
            run_processed_traffic=m.run_processed_traffic + node_add,
            run_max_node_usage=torch.maximum(m.run_max_node_usage, usage))
        # startup wait; a TTL expiry here releases the load immediately
        startup_at = _take2(state.sf_startup, node, sf_now)
        sw = torch.clamp(startup_at + proc_tab[..., 2] - t[:, None], min=0.0)
        drop_ttl_sw = admitted_n & (ttl - sw <= _EPS) & (sw > _EPS)
        ttl = torch.where(drop_ttl_sw, zero, ttl)
        started = admitted_n & ~drop_ttl_sw
        sw_s = torch.where(started, sw, zero)
        e2e = e2e + sw_s
        ttl = ttl - sw_s
        busy = torch.where(started, sw + pdel, zero)
        timer = torch.where(started, busy, timer)
        phase = torch.where(started, PH_PROC, phase)
        # release node load busy + duration after processing starts;
        # TTL-in-startup drops release now
        hold = torch.where(started, busy + duration,
                           torch.tensor(dt, device=dev))
        rel_who = started | drop_ttl_sw
        off_n = torch.clamp(torch.ceil(hold / dt).to(_I32), 1, H - 1)
        h_n = torch.remainder(ridx[:, None] + off_n, H)
        rel_node = _scatter_add(
            rel_node.view(B, H * N * P),
            torch.where(rel_who, h_n * (N * P) + node * P + sf_now, H * N * P),
            torch.where(rel_who, dr, zero)).view(B, H, N * P)

        # --- 7. departures & drops -----------------------------------------
        depart = depart_hop | depart_stay
        n_dep = depart.sum(-1, dtype=_I32)
        dep_e2e = torch.where(depart, e2e, zero)
        # the substep's three whole-slot sums at once (one host round trip)
        path_add, proc_add, dep_sum = slot_order_sum(
            torch.stack([path_cred, pdel_w, dep_e2e]))
        m = m.replace(
            sum_path_delay=m.sum_path_delay + path_add,
            run_path_delay_sum=m.run_path_delay_sum + path_add,
            sum_proc_delay=m.sum_proc_delay + proc_add,
            processed=m.processed + n_dep,
            run_processed=m.run_processed + n_dep,
            sum_e2e=m.sum_e2e + dep_sum,
            run_e2e_sum=m.run_e2e_sum + dep_sum,
            run_e2e_max=torch.maximum(m.run_e2e_max, dep_e2e.amax(-1)),
            active=m.active - n_dep)
        drops = [
            (drop_ttl0, DROP_DECISION),
            (drop_ttl_path, DROP_LINK_CAP),
            (drop_link, DROP_LINK_CAP),
            (drop_unplaced, DROP_NODE_CAP),
            (drop_ttl_pd, DROP_NODE_CAP),
            (drop_nodecap, DROP_NODE_CAP),
            (drop_ttl_sw, DROP_NODE_CAP),
        ]
        any_drop = torch.zeros(B, M, dtype=torch.bool, device=dev)
        adds = [torch.zeros(B, dtype=_I32, device=dev)
                for _ in range(m.drop_reasons.shape[1])]
        ttl_out = ttl <= _EPS
        for mask, reason in drops:
            any_drop = any_drop | mask
            # a drop with ttl<=0 is always recorded as TTL
            is_ttl = mask & ttl_out
            adds[DROP_TTL] = adds[DROP_TTL] + is_ttl.sum(-1, dtype=_I32)
            adds[reason] = adds[reason] + (mask & ~is_ttl).sum(-1, dtype=_I32)
        n_drop = any_drop.sum(-1, dtype=_I32)
        m = m.replace(
            drop_reasons=m.drop_reasons + torch.stack(adds, dim=-1),
            dropped=m.dropped + n_drop,
            run_dropped=m.run_dropped + n_drop,
            active=m.active - n_drop,
            run_dropped_per_node=_scatter_add(
                m.run_dropped_per_node, node, any_drop.to(_I32)))
        gone = depart | any_drop
        phase = torch.where(gone, PH_FREE, phase)

        # instances with load refresh last_active
        sf_last_active = torch.where(node_load > _EPS, t[:, None, None],
                                     state.sf_last_active)

        flows = FlowTable(phase=phase, sfc=sfc, position=position, node=node,
                          dest=dest, hop_next=hop_next, egress=egress, dr=dr,
                          duration=duration, ttl=ttl, e2e=e2e,
                          pend_path=pend_path, timer=timer)
        return state.replace(
            t=t + dt, flows=flows, cursor=cursor, node_load=node_load,
            sf_available=sf_available, edge_used=edge_used,
            sf_last_active=sf_last_active, rel_node=rel_node,
            rel_edge=rel_edge, metrics=m, truncated_arrivals=truncated)
