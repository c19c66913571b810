"""DDPG agent: actor, critic, Polyak targets and Adam.

The port of ``gsc_tpu.agents.ddpg.DDPG``: building and initialising the
networks (from an explicit ``torch.Generator``), the greedy inference
policy, the exploring ``choose_action``, the critic and actor losses, one
gradient step on a batch (critic step, then the actor step against the
updated critic, then Polyak averaging of both targets with tau), the
learn burst, and the single-env episode: one replay ring
(``init_buffer``), ``rollout_episode`` (an action per step, ``env.step``,
a replay write) and ``episode_step`` (the rollout, then the
end-of-episode learn burst on batches of that ring).  The single env runs
as a batch of one replica, so its actor forwards are batches of one
graph.  ``optax.adam`` becomes ``torch.optim.Adam`` with the same
learning rate, betas (0.9, 0.999) and eps 1e-8, in the form whose step
count stays on the device (``agents.adam.DeviceAdam``); neither side clips
gradients.  Both observation modes: a graph observation (``GraphObs``)
carries its action mask, a flat one (``AgentConfig.graph_mode`` false, a
[B, N*F] tensor) takes the env's, ``action_mask`` of the topology,
through ``ShuffleOps.step_mask``.

The single-env episode reads no value into Python between its dispatch
and the drain of its stats (``analysis.no_host_sync`` holds it): the
replay's write position, the Adam step counts and every stat stay on the
device.

Random draws stay outside the networks: ``choose_action`` takes its
warm-up uniforms and exploration normals from a ``Draws`` source, and the
learn burst its batches from a caller's ``sample_fn``, so a test can feed
this port and the JAX package the same numbers.  The learner state's
modules and optimisers are updated in place.

Two signals ride on tensors the update has already made, so neither
changes it: ``state_finite``, the all-finite flag of the learner state
(``resilience.guard.all_finite``) entering each episode (in the
rollout's stats) and after each learn burst (in its metrics); and, with
a ``learn_ledger`` (``obs.learning.LearnLedgerSpec``), the learning
signal: the replay's fill in the rollout's stats (``replay``) and, in
the burst's metrics (``learn_signal``), |TD| summed per topology over
every gradient step of the burst, with the Q moments and the per-layer
norms of its last step, accumulated on the device and read once per
episode.

Under the bf16 policy (``AgentConfig.precision``) the networks compute in
bf16 and the replay stores bf16 float leaves, while the parameters, both
Adam states and the Polyak updates stay f32, and the losses and TD
targets are f32: the networks' outputs are f32 and reward and done are
stored in f32.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config.schema import AgentConfig
from ..device import resolve_device
from ..env.actions import action_mask
from ..env.env import EnvState, ServiceCoordEnv
from ..env.observations import GraphObs, obs_map
from ..env.permutation import ShuffleOps
from ..models.nets import Actor, QNetwork, scale_action, unscale_action
from ..obs.learning import (LearnLedgerSpec, accumulate_signal,
                            learn_signal, replay_stats, td_segments,
                            zero_learn_signal)
from ..ops.gat import compute_dtype_of
from ..resilience.guard import all_finite
from ..sim.state import TrafficSchedule
from ..topology.compiler import Topology
from .adam import DeviceAdam
from .buffer import ReplayBuffer, buffer_add, buffer_init, buffer_sample

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Draws:
    """Where the agent's random numbers come from: warm-up uniforms,
    exploration normals, replay indices and the simulator's processing-
    delay noise.  The default draws from a seeded ``torch.Generator`` on
    the device; tests replace it to feed both frameworks the same
    numbers.

    ``rows`` = ``(lo, hi, B)`` makes this the source of one rank of a
    mesh, which rolls out replicas ``lo`` to ``hi - 1`` of ``B``: every
    draw with a replica axis (warm-up uniforms, exploration normals,
    processing-delay noise, ``shuffle_nodes`` permutations) is drawn
    whole, [B, ...], and sliced to those rows, so a replica's numbers and
    the generator's position never depend on the carving."""

    def __init__(self, seed: int, device, rows=None):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.rows = rows

    def whole(self, shape, draw):
        """``draw(shape)``, or under ``rows`` the [B, ...] draw's rows
        (a draw of None stays None)."""
        if self.rows is None:
            return draw(tuple(shape))
        lo, hi, total = self.rows
        if shape[0] != hi - lo:
            raise ValueError(f"a draw of {shape[0]} replicas on a rank "
                             f"that holds rows {lo}:{hi}")
        out = draw((total,) + tuple(shape[1:]))
        return None if out is None else out[lo:hi]

    def uniform(self, shape) -> torch.Tensor:
        """Warm-up action uniforms in [0, 1)."""
        return self.whole(shape, lambda s: torch.rand(
            s, generator=self.generator, device=self.device))

    def normal(self, shape) -> torch.Tensor:
        """Standard normals of the exploration noise."""
        return self.whole(shape, lambda s: torch.randn(
            s, generator=self.generator, device=self.device))

    def slots(self, batch: int, size: torch.Tensor) -> torch.Tensor:
        """Slot indices of one batch from one ring: uniform over its
        ``size`` filled slots (at least one)."""
        high = torch.clamp(size.to(self.device), min=1)
        u = torch.rand((batch,), generator=self.generator, device=self.device)
        return torch.minimum((u * high).long(), high.long() - 1)

    def replay(self, batch: int, replicas: int, sizes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(replica, slot) indices of one batch: the replica uniform over
        ``replicas``, the slot uniform over that replica's filled slots
        (at least one)."""
        bidx = torch.randint(0, replicas, (batch,), generator=self.generator,
                             device=self.device)
        high = torch.clamp(sizes.to(self.device)[bidx], min=1)
        u = torch.rand((batch,), generator=self.generator, device=self.device)
        sidx = torch.minimum((u * high).long(), high.long() - 1)
        return bidx, sidx

    def local(self, replicas: int, per: int, sizes: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(replica, slot) indices of a shard-local batch: ``per`` slots
        uniform over each replica's filled slots (at least one), the
        replicas in order (``gsc_tpu.parallel.dp``'s ``_sample_local``
        layout)."""
        high = torch.clamp(sizes.to(self.device), min=1)
        u = torch.rand((replicas, per), generator=self.generator,
                       device=self.device)
        sidx = torch.minimum((u * high[:, None]).long(),
                             high.long()[:, None] - 1)
        bidx = torch.arange(replicas, device=self.device).repeat_interleave(
            per)
        return bidx, sidx.reshape(-1)

    def sim_noise(self, engine, batch: int) -> Optional[torch.Tensor]:
        """Processing-delay normals of one interval, or None."""
        return self.whole((batch,), lambda s: engine.draw_noise(
            s[0], self.generator, self.device))


@dataclass
class DDPGState:
    """Learner state: networks, Polyak targets and both optimisers."""

    actor: Actor
    critic: QNetwork
    target_actor: Actor
    target_critic: QNetwork
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class DDPG:
    def __init__(self, env: ServiceCoordEnv, agent: AgentConfig,
                 gnn_impl: Optional[str] = None, device=None,
                 learn_ledger: Optional[LearnLedgerSpec] = None):
        self.env = env
        self.agent = agent
        self.learn_ledger = learn_ledger
        self.device = resolve_device(device)
        self.action_dim = env.limits.action_dim
        impl = gnn_impl or agent.gnn_impl
        sched_shape = env.limits.scheduling_shape
        self.actor = Actor(agent, self.action_dim, gnn_impl=impl,
                           sched_shape=sched_shape, obs_dim=env.obs_dim())
        self.critic = QNetwork(agent, self.action_dim, gnn_impl=impl,
                               sched_shape=sched_shape,
                               obs_dim=env.obs_dim())

    def init(self, generator: torch.Generator) -> Actor:
        """Draw the actor's parameters from ``generator`` (on the CPU, so a
        seed gives the same weights on every device) and move the actor to
        the agent's device."""
        self.actor.reset_parameters(generator)
        self.actor.to(self.device)
        return self.actor

    def init_state(self, generator: torch.Generator) -> DDPGState:
        """The learner state: actor, then critic parameters drawn from
        ``generator`` (on the CPU), targets as copies, fresh Adam states."""
        actor = self.init(generator)
        self.critic.reset_parameters(generator)
        critic = self.critic.to(self.device)
        adam = lambda m: DeviceAdam(
            m.parameters(), lr=self.agent.learning_rate, betas=ADAM_BETAS,
            eps=ADAM_EPS)
        return DDPGState(
            actor=actor, critic=critic,
            target_actor=copy.deepcopy(actor).requires_grad_(False),
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            actor_opt=adam(actor), critic_opt=adam(critic))

    def example_transition(self, sample_obs) -> Dict:
        """One replay transition's shapes and dtypes (no batch dim; a
        ``GraphObs`` or a flat observation).  Under a low-precision replay
        policy (``replay_cast_dtype``) the float leaves of obs/next_obs
        and the action are stored in that dtype; reward and done stay f32,
        bool and integer leaves as they are."""
        dev = (sample_obs.nodes if isinstance(sample_obs, GraphObs)
               else sample_obs).device
        obs = sample_obs
        action = torch.zeros(self.action_dim, device=dev)
        rd = compute_dtype_of(self.agent.precision_policy.replay_cast_dtype)
        if rd is not None:
            obs = obs_map(sample_obs, lambda x: x.to(rd)
                          if x.is_floating_point() else x)
            action = action.to(rd)
        return {"obs": obs, "next_obs": obs, "action": action,
                "reward": torch.zeros((), device=dev),
                "done": torch.zeros((), device=dev),
                "topo_idx": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_buffer(self, sample_obs) -> ReplayBuffer:
        """One replay ring of ``mem_limit`` transitions (``sample_obs``
        without a batch dim)."""
        return buffer_init(self.example_transition(sample_obs),
                           self.agent.mem_limit, device=self.device)

    def env_mask(self, topo: Topology, batch: int) -> Optional[torch.Tensor]:
        """The env's [batch, A] action mask (real source and destination
        nodes of ``topo``) that a flat observation does not carry; None
        in graph mode, where the observation's own mask is used."""
        if self.agent.graph_mode:
            return None
        limits = self.env.limits
        return action_mask(topo.expand(batch).node_mask, limits.num_sfcs,
                           limits.max_sfs)

    # ------------------------------------------------------------- actions
    @torch.inference_mode()
    def greedy_action(self, obs,
                      actor: Optional[Actor] = None) -> torch.Tensor:
        """The greedy policy: [..., A] actions for a (batched) observation,
        from ``actor`` (default: this agent's)."""
        a = (actor if actor is not None else self.actor)(obs)
        a = torch.clamp(a, 0.0, 1.0)
        return self.env.process_action(a)

    @torch.no_grad()
    def choose_action(self, actor: Actor, obs, mask: torch.Tensor,
                      global_step: int, draws: Draws) -> torch.Tensor:
        """Warm-up (``global_step < nb_steps_warmup_critic``): uniform
        random action times the mask; after it: the actor's action plus
        N(rand_mu, rand_sigma) noise in scaled [-1, 1] space, unscaled and
        clipped to [0, 1].  ``obs`` and ``mask`` carry a batch dim."""
        shape = mask.shape[:-1] + (self.action_dim,)
        if global_step < self.agent.nb_steps_warmup_critic:
            return draws.uniform(shape) * mask
        a = actor(obs)
        noise = self.agent.rand_mu + self.agent.rand_sigma * draws.normal(shape)
        return torch.clamp(unscale_action(scale_action(a) + noise), 0.0, 1.0)

    # ------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_episode(self, state: DDPGState, buffer: ReplayBuffer,
                        env_state: EnvState, obs, topo: Topology,
                        traffic: TrafficSchedule, episode_start_step: int,
                        draws: Draws, num_steps: Optional[int] = None
                        ) -> Tuple[DDPGState, ReplayBuffer, EnvState,
                                   object, Dict[str, torch.Tensor]]:
        """``num_steps`` (default ``episode_steps``) steps of the single
        env (a batch of one replica): action, env step, one transition
        into the ring ``buffer``, stamped with ``topo.topo_id``.
        ``episode_start_step`` is the global step of the first one (the
        warm-up gate reads it).  Returns the episode's stats (return, mean
        and final success ratio, mean end-to-end delay, the all-finite
        flag of the entering learner state and, with a ledger, the replay's
        fill), still on the device."""
        state_finite = all_finite(state)
        shuffle = ShuffleOps(self.agent, self.env.limits)
        perm = shuffle.init_perm(1, self.device, draws)
        obs = shuffle.permute_obs(obs, perm)
        env_mask = self.env_mask(topo, 1)
        first = lambda x: x[0]
        rewards, succ, e2e = [], [], []
        for i in range(num_steps or self.agent.episode_steps):
            mask = shuffle.step_mask(obs, env_mask, perm)
            action = self.choose_action(state.actor, obs, mask,
                                        episode_start_step + i, draws)
            action = self.env.process_action(action)
            env_state, next_obs, reward, done, info = self.env.step(
                env_state, topo, traffic, shuffle.env_action(action, perm),
                draws.sim_noise(self.env.engine, 1))
            next_obs, perm = shuffle.advance(next_obs, perm, draws)
            buffer_add(buffer, {
                "obs": obs_map(obs, first),
                "next_obs": obs_map(next_obs, first),
                "action": action[0], "reward": reward[0],
                "done": done[0].to(torch.float32), "topo_idx": topo.topo_id})
            rewards.append(reward[0])
            succ.append(info["succ_ratio"][0])
            e2e.append(info["avg_e2e_delay"][0])
            obs = next_obs
        s = torch.stack(succ)
        stats = {"episodic_return": torch.stack(rewards).sum(),
                 "mean_succ_ratio": s.mean(),
                 "mean_e2e_delay": torch.stack(e2e).mean(),
                 "final_succ_ratio": s[-1], "state_finite": state_finite}
        if self.learn_ledger is not None:
            stats["replay"] = replay_stats(buffer)
        return state, buffer, env_state, obs, stats

    def episode_step(self, state: DDPGState, buffer: ReplayBuffer,
                     env_state: EnvState, obs, topo: Topology,
                     traffic: TrafficSchedule, episode_start_step: int,
                     draws: Draws, learn: bool = False,
                     num_steps: Optional[int] = None, observe=None):
        """The rollout and, when ``learn``, the end-of-episode learn burst
        on batches of ``buffer``.  Returns (state, buffer, env_state, obs,
        stats, learn metrics or None).  ``observe(name)`` (a cost
        ledger's, ``obs.perf``) gives the context each of the two runs
        in, as ``rollout_episode`` and ``learn_burst``."""
        watch = observe or (lambda name: contextlib.nullcontext())
        with watch("rollout_episode"):
            state, buffer, env_state, obs, stats = self.rollout_episode(
                state, buffer, env_state, obs, topo, traffic,
                episode_start_step, draws, num_steps)
        metrics = None
        if learn:
            with watch("learn_burst"):
                state, metrics = self.learn_burst(
                    state, lambda: buffer_sample(buffer, draws,
                                                 self.agent.batch_size))
        return state, buffer, env_state, obs, stats, metrics

    # ------------------------------------------------------------ learning
    def critic_loss(self, state: DDPGState, batch: Dict
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean squared TD error against r + gamma (1 - done) Q'(s',
        clamp(pi'(s'), -1, 1)); returns (loss, q)."""
        loss, q, _ = self._critic_loss_td(state, batch)
        return loss, q

    def _critic_loss_td(self, state: DDPGState, batch: Dict):
        """(loss, q, td) with td = q - target, the loss's own residual."""
        with torch.no_grad():
            next_a = torch.clamp(state.target_actor(batch["next_obs"]),
                                 -1.0, 1.0)
            q_next = state.target_critic(batch["next_obs"], next_a)[..., 0]
            target = batch["reward"] + (1.0 - batch["done"]) \
                * self.agent.gamma * q_next
        q = state.critic(batch["obs"], batch["action"])[..., 0]
        td = q - target
        return torch.mean(td ** 2), q, td

    def actor_loss(self, state: DDPGState, batch: Dict) -> torch.Tensor:
        """-Q(s, pi(s)).mean() under the (current) critic."""
        a = state.actor(batch["obs"])
        return -torch.mean(state.critic(batch["obs"], a))

    def gradient_step_on_batch(self, state: DDPGState, batch: Dict,
                               signal: Optional[str] = None
                               ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
        """Critic Adam step, actor Adam step against the updated critic,
        then Polyak averaging with tau = target_model_update.  Updates
        ``state`` in place; the metrics stay on the device.  With a
        ledger, ``signal`` "td" adds this batch's per-topology |TD|
        (``learn_signal``) and "full" the whole signal (moments and layer
        norms too)."""
        c_params = list(state.critic.parameters())
        a_params = list(state.actor.parameters())
        critic_loss, q, td = self._critic_loss_td(state, batch)
        cgrad = torch.autograd.grad(critic_loss, c_params)
        for p, g in zip(c_params, cgrad):
            p.grad = g
        state.critic_opt.step()
        actor_loss = self.actor_loss(state, batch)
        agrad = torch.autograd.grad(actor_loss, a_params)
        for p, g in zip(a_params, agrad):
            p.grad = g
        state.actor_opt.step()
        tau = self.agent.target_model_update
        with torch.no_grad():
            for tgt, src in ((state.target_actor, state.actor),
                             (state.target_critic, state.critic)):
                for tp, p in zip(tgt.parameters(), src.parameters()):
                    tp.copy_(tau * p + (1 - tau) * tp)
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(),
                   "q_values": q.detach().mean(),
                   "critic_grad_norm": global_norm(cgrad),
                   "actor_grad_norm": global_norm(agrad)}
        spec = self.learn_ledger
        if spec is not None and signal == "td":
            metrics["learn_signal"] = td_segments(spec, batch["topo_idx"], td)
        elif spec is not None and signal == "full":
            actor = dict(state.actor.named_parameters())
            critic = dict(state.critic.named_parameters())
            metrics["learn_signal"] = learn_signal(
                spec, batch["topo_idx"], td, q,
                params={"actor": actor, "critic": critic},
                grads={"actor": dict(zip(actor, agrad)),
                       "critic": dict(zip(critic, cgrad))})
        return state, metrics

    def learn_burst(self, state: DDPGState, sample_fn: Callable[[], Dict],
                    steps: Optional[int] = None
                    ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
        """End-of-episode training: ``learn_steps`` (default
        ``episode_steps``) gradient steps, each on ``sample_fn()``'s batch;
        returns the last step's metrics, the all-finite flag of the
        updated state (``state_finite``) and, with a ledger, the burst's
        learning signal."""
        n = (steps if steps is not None else self.agent.learn_steps
             if self.agent.learn_steps is not None
             else self.agent.episode_steps)
        ledger = self.learn_ledger is not None
        acc = zero_learn_signal(self.learn_ledger, self.device) \
            if ledger else None
        metrics = {}
        for i in range(n):
            state, metrics = self.gradient_step_on_batch(
                state, sample_fn(),
                signal=("full" if i == n - 1 else "td") if ledger else None)
            if ledger:
                acc = accumulate_signal(acc, metrics["learn_signal"])
        if ledger:
            metrics["learn_signal"] = acc
        metrics["state_finite"] = all_finite(state)
        return state, metrics
