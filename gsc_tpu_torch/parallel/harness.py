"""Chunked episodes: the replica-parallel training loop.

The port of ``gsc_tpu.parallel.harness.run_chunked_episodes``: each
episode resets every replica on its network and traffic and runs
``episode_steps / chunk`` chunks, the final one carrying the
end-of-episode learn burst.  The global step of a chunk counts from
episode 0, so a run resumed at ``start_episode`` continues the warm-up
schedule where it stood.  Per-episode numbers, handed to the caller's
``on_episode``, are taken over all chunks: the return sums them, the mean
success ratio averages them, and the final success ratio is the last
step's; the per-replica returns sum each replica's chunks, so that a
mixed batch's caller can attribute them per network.  On a rank of a
mesh (``ParallelDDPG`` with a plan) ``episode_inputs`` gives the rank's
replica rows, and each chunk's stats arrive already gathered into global
replica order: every number here is the one a run without a mesh logs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple


def run_chunked_episodes(pddpg, episode_inputs: Callable, state, buffers,
                         episodes: int, episode_steps: int, chunk: int,
                         on_episode: Callable, start_episode: int = 0,
                         observe: Optional[Callable] = None) -> Tuple:
    """Train episodes ``start_episode`` to ``episodes - 1``; returns
    (state, buffers), updated in place.

    ``episode_inputs(ep)`` gives episode ``ep``'s (topology, [B]-stacked
    traffic) on the device, the topology shared or stacked per replica;
    ``on_episode(ep, result)`` runs after each episode's learn burst with
    ``result``: ``episodic_return``, ``mean_succ_ratio`` and
    ``final_succ_ratio`` (floats), ``per_replica_return`` (a list of B
    floats), ``learn`` (the burst's metrics, on the device) and
    ``replay`` (the shards' fill with a learn ledger, else None).
    ``observe(name)`` (a cost ledger's, ``obs.perf``) gives the context
    each learning chunk runs in, as ``chunk_step``, and its burst, as
    ``learn_burst``."""
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
            learn = c == n_chunks - 1
            with (observe("chunk_step") if observe is not None and learn
                  else contextlib.nullcontext()):
                state, buffers, env_states, obs, stats, metrics = \
                    pddpg.chunk_step(state, buffers, env_states, obs, topo,
                                     traffic, start, chunk, learn=learn,
                                     observe=observe)
            chunk_stats.append(stats)
        # device scalars are read once the episode has been issued
        per_replica = sum(s["per_replica_return"] for s in chunk_stats)
        on_episode(ep, {
            "episodic_return": sum(float(s["episodic_return"])
                                   for s in chunk_stats),
            "mean_succ_ratio": sum(float(s["mean_succ_ratio"])
                                   for s in chunk_stats) / n_chunks,
            "final_succ_ratio": float(chunk_stats[-1]["final_succ_ratio"]),
            "per_replica_return": per_replica.tolist(),
            "learn": metrics,
            "replay": chunk_stats[-1].get("replay")})
    return state, buffers
