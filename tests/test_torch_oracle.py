"""The linkcap oracle of the reference simulator, held by the port.

The frozen numbers are tests/test_reference_parity.py:106-123's
``ORACLE["linkcap"]`` (the unmodified reference coordsim on the repo's
own inputs, tests/assets/line3-linkcap2.graphml and linkcap_config.yaml,
50 uniform control steps at seed 1234; copied here, not imported: that
module skips without the reference tree).  The service is the
reference's abc chain (3 x 5 ms SFs, test_reference_parity.py:10-12),
``config.abc_service`` in the port.  The port's harness is
``gsc_tpu_torch.sim.oracle.uniform_engine_run``, the copy of
tools/reward_curve.py:78-130 (the ``cli simulate`` semantics: a uniform
schedule over the real nodes, every SF placed on every real node, 24
nodes and 37 edges), run on the CPU (its plain engine; chip_smoke.py
phase 24 runs it through kernel #2).

- ``test_linkcap_oracle_constants`` (marked slow: 50 intervals of the
  plain engine take ~45 s on one CPU thread) holds the constants with
  the rules of test_reference_parity.py:160-184's
  ``test_engine_matches_reference`` for an ``atol_flows`` oracle:
  generated exact; processed, dropped and each drop reason within 30
  flows; every reason the oracle has at zero exactly zero; the average
  end-to-end delay within 5% relative;
- ``test_linkcap_harness_matches_the_jax_engine``: the harness's first
  intervals against the JAX package's engine driven as
  tools/reward_curve.py drives it, on the same files and seed: the
  cumulative counters exact and the end-to-end sum within rtol 1e-5
  (the engine tolerance of tests/test_torch_substep.py);
- without ``device="cpu"`` the harness asks for the card.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.loader import load_sim as j_load_sim
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.sim.engine import SimEngine as JEngine
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology.compiler import load_topology as j_load_topology

from gsc_tpu_torch.sim.oracle import oracle_numbers, uniform_engine_run
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETWORK = os.path.join(REPO, "tests", "assets", "line3-linkcap2.graphml")
CONFIG = os.path.join(REPO, "tests", "assets", "linkcap_config.yaml")
STEPS, SEED = 50, 1234
# tests/test_reference_parity.py:106-123
LINKCAP = {
    "generated": 2500, "processed": 151, "dropped": 2348,
    "drop_reasons": {"TTL": 0, "DECISION": 0, "LINK_CAP": 2348,
                     "NODE_CAP": 0},
    "avg_e2e": 22.94701986754967,
    "atol_flows": 30,
    "e2e_rel": 0.05,
}


def check_oracle(got, want):
    """test_reference_parity.py:160-184's rules for an atol oracle."""
    atol = want["atol_flows"]
    assert got["generated"] == want["generated"], got
    assert abs(got["processed"] - want["processed"]) <= atol, got
    assert abs(got["dropped"] - want["dropped"]) <= atol, got
    assert got["avg_e2e"] == pytest.approx(want["avg_e2e"],
                                           rel=want["e2e_rel"])
    for reason, n in want["drop_reasons"].items():
        assert abs(got["drop_reasons"][reason] - n) <= atol, got
        if n == 0:
            assert got["drop_reasons"][reason] == 0, got


@pytest.mark.slow
def test_linkcap_oracle_constants():
    metrics, n_real, _ = uniform_engine_run(NETWORK, STEPS, SEED, CONFIG,
                                            device="cpu")
    assert n_real == 3
    check_oracle(oracle_numbers(metrics), LINKCAP)


def test_linkcap_harness_matches_the_jax_engine():
    steps = 3
    _, _, rows = uniform_engine_run(NETWORK, steps, SEED, CONFIG,
                                    device="cpu", per_step=True)
    svc, cfg = j_abc(), j_load_sim(CONFIG)
    limits = JLimits.for_service(svc, max_nodes=24, max_edges=37)
    topo = j_load_topology(NETWORK, max_nodes=24, max_edges=37, seed=SEED)
    traffic = j_traffic(cfg, svc, topo, steps, SEED)
    engine = JEngine(svc, cfg, limits)
    nm = np.asarray(topo.node_mask)
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, nm] = 1.0 / nm.sum()
    placement = jnp.asarray(
        np.broadcast_to(nm[:, None], (24, limits.max_sfs)).copy())
    state = engine.init(jax.random.PRNGKey(SEED), topo)
    for i in range(steps):
        state, m = engine.apply(state, topo, traffic, jnp.asarray(sched),
                                placement)
        got = rows[i]
        assert got["generated"] == int(m.generated) > 0
        assert got["processed"] == int(m.processed)
        assert got["dropped"] == int(m.dropped)
        assert got["drop_reasons"] == np.asarray(m.drop_reasons).tolist()
        assert got["e2e_sum"] == pytest.approx(float(m.sum_e2e), rel=1e-5,
                                               abs=1e-5)
    assert rows[-1]["drop_reasons"][2] > 0


def test_the_harness_runs_on_the_card_unless_told():
    """No card here: the default device raises, as every entry point."""
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        uniform_engine_run(NETWORK, 1, SEED, CONFIG)
