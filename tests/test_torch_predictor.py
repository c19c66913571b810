"""Traffic prediction in the port against the JAX package.

``predict_ingress_traffic`` and ``interval_traffic_series`` on the same
TrafficSchedule arrays (integer and random data rates); the GRU
forecaster's outputs and ``predict`` under parameters converted from a
trained flax forecaster (``utils.convert.gru_forecaster_from_jax``);
``fit`` learning the alternating series of tests/test_predictor.py:66-80;
and the env's observations under ``prediction: true`` (the first one and
after a step) equal to the JAX env's, the first one showing the upcoming
traffic where the observed mode shows none.

Tolerances: the analytic prediction and the series rtol 1e-5, atol 1e-5
(f32 sums over a node's arrivals, added in another order by XLA's
scatter); the forecaster rtol 1e-5, atol 1e-5 (an f32 GRU over 12 steps,
torch's and XLA's matmuls add in other orders); observations rtol 1e-5,
atol 1e-5, the bar of tests/test_torch_env.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env import ServiceCoordEnv as JEnv
from gsc_tpu.sim import RNNTrafficPredictor as JRNN
from gsc_tpu.sim import generate_traffic as j_traffic
from gsc_tpu.sim import interval_traffic_series as j_series
from gsc_tpu.sim import predict_ingress_traffic as j_predict
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         ServiceConfig, ServiceFunction,
                                         SimConfig)
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.sim import (RNNTrafficPredictor, interval_traffic_series,
                               predict_ingress_traffic)
from gsc_tpu_torch.sim.predictor import GRUForecaster
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from gsc_tpu_torch.utils.convert import gru_forecaster_from_jax
from test_torch_env import _to_port_traffic
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
N, E = 8, 8
SPEC = dict(node_caps=[10.0] * 3, node_types=["Ingress", "Normal", "Normal"],
            edges=[(0, 1, 100.0, 3.0), (1, 2, 100.0, 3.0)])


def _services():
    sf = lambda F, n: F(name=n, processing_delay_mean=5.0,
                        processing_delay_stdev=0.0)
    return (JService(sfc_list={"sfc_1": ("a", "b", "c")},
                     sf_list={n: sf(JSF, n) for n in "abc"}),
            ServiceConfig(sfc_list={"sfc_1": ("a", "b", "c")},
                          sf_list={n: sf(ServiceFunction, n) for n in "abc"}))


def _topos():
    return (j_compile(JSpec(**SPEC), max_nodes=N, max_edges=E),
            compile_topology(NetworkSpec(**SPEC), max_nodes=N, max_edges=E))


@pytest.mark.parametrize("dr_stdev", [0.0, 0.35])
def test_predict_ingress_traffic_matches_jax(dr_stdev):
    jsvc, _ = _services()
    jtopo, _ = _topos()
    cfg = JSim(ttl_choices=(100.0,), flow_dr_stdev=dr_stdev,
               inter_arrival_mean=3.0)
    jt = j_traffic(cfg, jsvc, jtopo, 4, seed=2)
    tt = _to_port_traffic(jt)
    runs = [0, 1, 3, 10]
    got = predict_ingress_traffic(tt, torch.tensor(runs, dtype=torch.int32),
                                  100.0, N)
    for r, run in enumerate(runs):
        want = np.asarray(j_predict(jt, jnp.asarray(run), 100.0, N))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    assert float(got[0, 0]) > 0 and float(got[3].sum()) == 0.0
    np.testing.assert_allclose(interval_traffic_series(tt, 100.0, 4, N),
                               j_series(jt, 100.0, 4, N), rtol=RTOL,
                               atol=ATOL)


def _alternating():
    return np.asarray([10, 2, 10, 2, 10, 2, 10, 2, 10, 2, 10, 2], np.float32)


def test_gru_forecaster_matches_flax_under_converted_params():
    sig = _alternating()
    jp = JRNN(hidden=8, lr=2e-2, seed=0)
    jp.fit(sig, epochs=30)
    tp = RNNTrafficPredictor(hidden=8)
    tp.model = GRUForecaster(8)
    tp.model.load_state_dict(gru_forecaster_from_jax(
        jax.device_get(jp.params)))
    tp.lo, tp.hi = jp.lo, jp.hi
    s = (sig - jp.lo) / (jp.hi - jp.lo)
    want = np.asarray(jp.model.apply(jp.params, jnp.asarray(s[:, None])))
    with torch.no_grad():
        got = tp.model(torch.from_numpy(s[:, None])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for k in (3, 5, 6, 12):
        assert tp.predict(sig[:k]) == pytest.approx(jp.predict(sig[:k]),
                                                    rel=RTOL, abs=ATOL)
    assert float(tp.model.gru.bias_hh_l0.detach()[:16].abs().max()) == 0.0


def test_fit_learns_alternating_series():
    sig = _alternating()
    pred = RNNTrafficPredictor(hidden=8, lr=2e-2, seed=0)
    loss = pred.fit(sig, epochs=400)
    assert loss < 0.05
    assert pred.predict(sig[:5]) < 6.0     # history ends on 10 -> next ~2
    assert pred.predict(sig[:6]) > 6.0     # history ends on 2 -> next ~10
    # the hidden biases flax lacks stayed zero through training
    assert float(pred.model.gru.bias_hh_l0.detach()[:16].abs().max()) == 0.0
    with pytest.raises(RuntimeError):
        RNNTrafficPredictor().predict(sig)


def test_prediction_changes_observations_as_in_jax():
    jsvc, tsvc = _services()
    jtopo, ttopo = _topos()
    kw = dict(ttl_choices=(100.0,))
    jlim = JLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    tlim = EnvLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    jt = j_traffic(JSim(**kw), jsvc, jtopo, 3, seed=0)
    tt = _to_port_traffic(jt)
    obs = {}
    for pred in (False, True):
        jenv = JEnv(jsvc, JSim(**kw, prediction=pred),
                    JAgent(graph_mode=True, episode_steps=2), jlim)
        tenv = ServiceCoordEnv(tsvc, SimConfig(**kw, prediction=pred),
                               AgentConfig(episode_steps=2), tlim)
        js, jo = jenv.reset(jax.random.PRNGKey(0), jtopo, jt)
        ts, to = tenv.reset(ttopo, tt, batch=1)
        np.testing.assert_allclose(to.nodes[0].numpy(), np.asarray(jo.nodes),
                                   rtol=RTOL, atol=ATOL)
        obs[pred] = to.nodes[0, 0, 0].item()
        sched = np.zeros(tlim.scheduling_shape, np.float32)
        sched[:, :, :, 1] = 1.0
        js, jo, *_ = jenv.step(js, jtopo, jt, jnp.asarray(sched.reshape(-1)))
        ts, to, *_ = tenv.step(ts, ttopo, tt,
                               torch.from_numpy(sched.reshape(1, -1)))
        np.testing.assert_allclose(to.nodes[0].numpy(), np.asarray(jo.nodes),
                                   rtol=RTOL, atol=ATOL)
    assert obs[False] == 0.0 and obs[True] > 0.5
