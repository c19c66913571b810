"""Chunked episodes: the replica-parallel training loop.

The port of ``gsc_tpu.parallel.harness.run_chunked_episodes`` without the
telemetry hub: each episode resets every replica on its network and
traffic and runs ``episode_steps / chunk`` chunks, the final one carrying
the end-of-episode learn burst.  The global step of a chunk counts from
episode 0, so a run resumed at ``start_episode`` continues the warm-up
schedule where it stood.  Per-episode numbers, handed to the caller's
``on_episode``, are taken over all chunks: the return sums them, the mean
success ratio averages them, and the final success ratio is the last
step's.
"""
from __future__ import annotations

from typing import Callable, Tuple


def run_chunked_episodes(pddpg, episode_inputs: Callable, state, buffers,
                         episodes: int, episode_steps: int, chunk: int,
                         on_episode: Callable, start_episode: int = 0
                         ) -> Tuple:
    """Train episodes ``start_episode`` to ``episodes - 1``; returns
    (state, buffers), updated in place.

    ``episode_inputs(ep)`` gives episode ``ep``'s (topology, [B]-stacked
    traffic) on the device; ``on_episode(ep, ret, mean_succ, final_succ,
    learn_metrics)`` runs after each episode's learn burst."""
    if episode_steps % chunk != 0:
        raise ValueError(f"chunk ({chunk}) must divide episode_steps "
                         f"({episode_steps})")
    n_chunks = episode_steps // chunk
    for ep in range(start_episode, episodes):
        topo, traffic = episode_inputs(ep)
        env_states, obs = pddpg.reset_all(topo, traffic)
        chunk_stats = []
        for c in range(n_chunks):
            start = ep * episode_steps + c * chunk
            state, buffers, env_states, obs, stats, metrics = \
                pddpg.chunk_step(state, buffers, env_states, obs, topo,
                                 traffic, start, chunk,
                                 learn=(c == n_chunks - 1))
            chunk_stats.append(stats)
        # device scalars are read once the episode has been issued
        on_episode(ep,
                   sum(float(s["episodic_return"]) for s in chunk_stats),
                   sum(float(s["mean_succ_ratio"]) for s in chunk_stats)
                   / n_chunks,
                   float(chunk_stats[-1]["final_succ_ratio"]), metrics)
    return state, buffers
