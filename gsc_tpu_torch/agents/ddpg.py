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
learning rate, betas (0.9, 0.999) and eps 1e-8; neither side clips
gradients.

Random draws stay outside the networks: ``choose_action`` takes its
warm-up uniforms and exploration normals from a ``Draws`` source, and the
learn burst its batches from a caller's ``sample_fn``, so a test can feed
this port and the JAX package the same numbers.  The learner state's
modules and optimisers are updated in place.

Under the bf16 policy (``AgentConfig.precision``) the networks compute in
bf16 and the replay stores bf16 float leaves, while the parameters, both
Adam states and the Polyak updates stay f32, and the losses and TD
targets are f32: the networks' outputs are f32 and reward and done are
stored in f32.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config.schema import AgentConfig
from ..device import resolve_device
from ..env.env import EnvState, ServiceCoordEnv
from ..env.observations import GraphObs
from ..env.permutation import ShuffleOps
from ..models.nets import Actor, QNetwork, scale_action, unscale_action
from ..ops.gat import compute_dtype_of
from ..sim.state import TrafficSchedule
from ..topology.compiler import Topology
from .buffer import ReplayBuffer, buffer_add, buffer_init, buffer_sample

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Draws:
    """Where the agent's random numbers come from: warm-up uniforms,
    exploration normals, replay indices and the simulator's processing-
    delay noise.  The default draws from a seeded ``torch.Generator`` on
    the device; tests replace it to feed both frameworks the same
    numbers."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape) -> torch.Tensor:
        """Warm-up action uniforms in [0, 1)."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """Standard normals of the exploration noise."""
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

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

    def sim_noise(self, engine, batch: int) -> Optional[torch.Tensor]:
        """Processing-delay normals of one interval, or None."""
        return engine.draw_noise(batch, self.generator, self.device)


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
                 gnn_impl: Optional[str] = None, device=None):
        self.env = env
        self.agent = agent
        self.device = resolve_device(device)
        self.action_dim = env.limits.action_dim
        impl = gnn_impl or agent.gnn_impl
        sched_shape = env.limits.scheduling_shape
        self.actor = Actor(agent, self.action_dim, gnn_impl=impl,
                           sched_shape=sched_shape)
        self.critic = QNetwork(agent, self.action_dim, gnn_impl=impl,
                               sched_shape=sched_shape)

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
        adam = lambda m: torch.optim.Adam(
            m.parameters(), lr=self.agent.learning_rate, betas=ADAM_BETAS,
            eps=ADAM_EPS)
        return DDPGState(
            actor=actor, critic=critic,
            target_actor=copy.deepcopy(actor).requires_grad_(False),
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            actor_opt=adam(actor), critic_opt=adam(critic))

    def example_transition(self, sample_obs: GraphObs) -> Dict:
        """One replay transition's shapes and dtypes (no batch dim).  Under
        a low-precision replay policy (``replay_cast_dtype``) the float
        leaves of obs/next_obs and the action are stored in that dtype;
        reward and done stay f32, bool and integer leaves as they are."""
        dev = sample_obs.nodes.device
        obs = sample_obs
        action = torch.zeros(self.action_dim, device=dev)
        rd = compute_dtype_of(self.agent.precision_policy.replay_cast_dtype)
        if rd is not None:
            obs = sample_obs.map(lambda x: x.to(rd) if x.is_floating_point()
                                 else x)
            action = action.to(rd)
        return {"obs": obs, "next_obs": obs, "action": action,
                "reward": torch.zeros((), device=dev),
                "done": torch.zeros((), device=dev),
                "topo_idx": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_buffer(self, sample_obs: GraphObs) -> ReplayBuffer:
        """One replay ring of ``mem_limit`` transitions (``sample_obs``
        without a batch dim)."""
        return buffer_init(self.example_transition(sample_obs),
                           self.agent.mem_limit, device=self.device)

    # ------------------------------------------------------------- actions
    @torch.inference_mode()
    def greedy_action(self, obs: GraphObs,
                      actor: Optional[Actor] = None) -> torch.Tensor:
        """The greedy policy: [..., A] actions for a (batched) observation,
        from ``actor`` (default: this agent's)."""
        a = (actor if actor is not None else self.actor)(obs)
        a = torch.clamp(a, 0.0, 1.0)
        return self.env.process_action(a)

    @torch.no_grad()
    def choose_action(self, actor: Actor, obs: GraphObs, mask: torch.Tensor,
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
                        env_state: EnvState, obs: GraphObs, topo: Topology,
                        traffic: TrafficSchedule, episode_start_step: int,
                        draws: Draws, num_steps: Optional[int] = None
                        ) -> Tuple[DDPGState, ReplayBuffer, EnvState,
                                   GraphObs, Dict[str, torch.Tensor]]:
        """``num_steps`` (default ``episode_steps``) steps of the single
        env (a batch of one replica): action, env step, one transition
        into the ring ``buffer``, stamped with ``topo.topo_id``.
        ``episode_start_step`` is the global step of the first one (the
        warm-up gate reads it).  Returns the episode's stats (return, mean
        and final success ratio, mean end-to-end delay), still on the
        device."""
        shuffle = ShuffleOps(self.agent, self.env.limits)
        perm = shuffle.init_perm(1, self.device)
        obs = shuffle.permute_obs(obs, perm)
        first = lambda x: x[0]
        rewards, succ, e2e = [], [], []
        for i in range(num_steps or self.agent.episode_steps):
            mask = shuffle.step_mask(obs, None, perm)
            action = self.choose_action(state.actor, obs, mask,
                                        episode_start_step + i, draws)
            action = self.env.process_action(action)
            env_state, next_obs, reward, done, info = self.env.step(
                env_state, topo, traffic, shuffle.env_action(action, perm),
                draws.sim_noise(self.env.engine, 1))
            next_obs, perm = shuffle.advance(next_obs, perm)
            buffer_add(buffer, {
                "obs": obs.map(first), "next_obs": next_obs.map(first),
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
                 "final_succ_ratio": s[-1]}
        return state, buffer, env_state, obs, stats

    def episode_step(self, state: DDPGState, buffer: ReplayBuffer,
                     env_state: EnvState, obs: GraphObs, topo: Topology,
                     traffic: TrafficSchedule, episode_start_step: int,
                     draws: Draws, learn: bool = False,
                     num_steps: Optional[int] = None):
        """The rollout and, when ``learn``, the end-of-episode learn burst
        on batches of ``buffer``.  Returns (state, buffer, env_state, obs,
        stats, learn metrics or None)."""
        state, buffer, env_state, obs, stats = self.rollout_episode(
            state, buffer, env_state, obs, topo, traffic, episode_start_step,
            draws, num_steps)
        metrics = None
        if learn:
            state, metrics = self.learn_burst(
                state, lambda: buffer_sample(buffer, draws,
                                             self.agent.batch_size))
        return state, buffer, env_state, obs, stats, metrics

    # ------------------------------------------------------------ learning
    def critic_loss(self, state: DDPGState, batch: Dict
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean squared TD error against r + gamma (1 - done) Q'(s',
        clamp(pi'(s'), -1, 1)); returns (loss, q)."""
        with torch.no_grad():
            next_a = torch.clamp(state.target_actor(batch["next_obs"]),
                                 -1.0, 1.0)
            q_next = state.target_critic(batch["next_obs"], next_a)[..., 0]
            target = batch["reward"] + (1.0 - batch["done"]) \
                * self.agent.gamma * q_next
        q = state.critic(batch["obs"], batch["action"])[..., 0]
        td = q - target
        return torch.mean(td ** 2), q

    def actor_loss(self, state: DDPGState, batch: Dict) -> torch.Tensor:
        """-Q(s, pi(s)).mean() under the (current) critic."""
        a = state.actor(batch["obs"])
        return -torch.mean(state.critic(batch["obs"], a))

    def gradient_step_on_batch(self, state: DDPGState, batch: Dict
                               ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
        """Critic Adam step, actor Adam step against the updated critic,
        then Polyak averaging with tau = target_model_update.  Updates
        ``state`` in place; the metrics stay on the device."""
        c_params = list(state.critic.parameters())
        a_params = list(state.actor.parameters())
        critic_loss, q = self.critic_loss(state, batch)
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
        return state, metrics

    def learn_burst(self, state: DDPGState, sample_fn: Callable[[], Dict],
                    steps: Optional[int] = None
                    ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
        """End-of-episode training: ``learn_steps`` (default
        ``episode_steps``) gradient steps, each on ``sample_fn()``'s batch;
        returns the last step's metrics."""
        n = (steps if steps is not None else self.agent.learn_steps
             if self.agent.learn_steps is not None
             else self.agent.episode_steps)
        metrics = {}
        for _ in range(n):
            state, metrics = self.gradient_step_on_batch(state, sample_fn())
        return state, metrics
