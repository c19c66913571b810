"""The single-env dispatch region reads nothing back to the host, in both
observation modes: the port's mirror of the JAX package's
``test_steady_state_dispatch_performs_zero_host_syncs``
(tests/test_analysis.py).

Traffic is sampled before the region (the prefetcher's job), episode 0
runs outside it (first calls build the device tables and, on the card,
load the kernels), then episodes 1 and 2 run ``env.reset`` plus
``DDPG.episode_step(..., learn=True)`` under
``analysis.no_host_sync``: on the CPU it fails on a value read into
Python (``.item()``, ``float()``, ``bool()``), on the card on every
synchronizing CUDA operation too.  The per-episode stats drain after the
region; drained inside it, the sentinel trips.  The tiny stack is
tests/test_torch_single_env.py's (a triangle padded to 8 nodes, 4-step
episodes, 2 warm-up steps, so every episode ends in a learn burst), with
and without the learn ledger.  This file imports no JAX: the card runs
it (``python -m pytest --noconftest tests/test_torch_no_host_sync.py -m
cuda``).
"""
import math

import pytest
import torch

from gsc_tpu_torch.agents.trainer import Trainer, _first
from gsc_tpu_torch.analysis import HostSyncError, no_host_sync
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         SchedulerConfig, SimConfig)
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.obs.learning import LearnLedgerSpec
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from test_torch_single_env import AGENT_KW, SIM_KW, TRI
from torch_port_helpers import one_torch_thread  # noqa: F401

N = E = 8


def _stack(device, graph_mode, ledger):
    agent = AgentConfig(**AGENT_KW, graph_mode=graph_mode, gnn_impl="pallas")
    sim = SimConfig(**SIM_KW)
    env = ServiceCoordEnv(abc_service(), sim, agent,
                          EnvLimits.for_service(abc_service(), max_nodes=N,
                                                max_edges=E))
    topos = [compile_topology(synthetic.triangle(**TRI), max_nodes=N,
                              max_edges=E),
             compile_topology(synthetic.line(4), max_nodes=N, max_edges=E)]
    driver = EpisodeDriver(SchedulerConfig(("tri", "line"), "line", 1), sim,
                           abc_service(), agent.episode_steps, max_nodes=N,
                           max_edges=E, base_seed=3, topologies=topos,
                           inference_topology=topos[1])
    spec = LearnLedgerSpec.for_topos(2) if ledger else None
    return Trainer(env, driver, agent, seed=3, device=device,
                   learn_ledger=spec)


def steady_state_dispatch(device, graph_mode, ledger):
    """Episodes 1 and 2 under the sentinel; returns their stats and learn
    metrics, still on the device."""
    trainer = _stack(device, graph_mode, ledger)
    env, ddpg, draws = trainer.env, trainer.ddpg, trainer.draws
    steps = trainer.agent_cfg.episode_steps
    episodes = [trainer._episode(ep) for ep in range(3)]
    state = trainer.init_state()
    _, obs0 = env.reset(*episodes[0], batch=1)
    ring = ddpg.init_buffer(_first(obs0))

    def episode(ep):
        es, obs = env.reset(*episodes[ep], batch=1)
        return ddpg.episode_step(state, ring, es, obs, *episodes[ep],
                                 ep * steps, draws, learn=True)

    episode(0)
    outs = []
    with no_host_sync("steady-state episode dispatch"):
        for ep in (1, 2):
            out = episode(ep)
            outs.append((out[4], out[5]))
    return outs


def _check_drained(outs, ledger):
    for stats, metrics in outs:
        assert math.isfinite(float(stats["episodic_return"]))
        assert math.isfinite(float(metrics["critic_loss"]))
        assert float(stats["state_finite"]) == float(
            metrics["state_finite"]) == 1.0
        assert ("replay" in stats) == ledger
        assert ("learn_signal" in metrics) == ledger


@pytest.mark.parametrize("ledger", [False, True], ids=["plain", "ledger"])
@pytest.mark.parametrize("graph_mode", [True, False], ids=["graph", "flat"])
def test_steady_state_dispatch_reads_nothing_back(graph_mode, ledger):
    outs = steady_state_dispatch("cpu", graph_mode, ledger)
    # the drain belongs outside the dispatch region: inside, it trips
    with pytest.raises(HostSyncError, match="dispatch region"):
        with no_host_sync("dispatch region"):
            float(outs[0][0]["episodic_return"])
    _check_drained(outs, ledger)


@pytest.mark.cuda
@pytest.mark.parametrize("graph_mode", [True, False], ids=["graph", "flat"])
def test_steady_state_dispatch_on_the_card(graph_mode):
    """The same on the card, through the kernels: no synchronizing CUDA
    operation either (the replay's write position, the Adam step counts
    and the device tables stay on the device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    from gsc_tpu_torch.ops.substep import substep_megakernel

    before = substep_megakernel.launches
    outs = steady_state_dispatch("cuda", graph_mode, True)
    assert substep_megakernel.launches > before
    _check_drained(outs, True)
