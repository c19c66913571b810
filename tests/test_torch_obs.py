"""The port's run observability against the JAX package's, on the CPU.

- the hub's ``metrics.json`` exposition (``snapshot()``) and series rings
  equal the JAX ``MetricsHub``'s when both are fed one sequence of
  counters, gauges, histograms and series points: exactly;
- ``extract_curves`` equals the JAX package's on one event list (NaN,
  inf, two runs, two topologies): exactly;
- ``learn_signal``, ``layer_norms`` and ``replay_stats`` on numpy-seeded
  td, q, topo_idx and flax parameters and gradients converted by
  ``utils.convert``: the same layer names, values within rtol 1e-6
  (f32 sums in another order), the emitted ``learn_signal`` events equal
  to 1e-6;
- ``select_best_agent``: the same pick;
- the watchdog through an injected clock and explicit polls (no wall
  sleeps against a budget): one stall per quiet spell, re-armed by a
  beat, an escalation after ``escalate_after`` more budgets;
- the sinks' JSON coercion of torch tensors, the device records on the
  CPU, and the ``/metrics`` endpoint on localhost.
"""
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

from gsc_tpu_torch.obs import (ListSink, MetricsEndpoint, MetricsHub,
                               PipelineWatchdog, device_memory_snapshot,
                               extract_curves)
from gsc_tpu_torch.obs.learning import (LearnLedgerSpec, emit_learn_signal,
                                        learn_signal, replay_stats)
from gsc_tpu_torch.obs.sinks import jsonable
from gsc_tpu_torch.utils.convert import params_from_jax
from gsc_tpu_torch.utils.experiment import select_best_agent, to_yaml
from torch_port_helpers import one_torch_thread  # noqa: F401


def _feed(hub):
    hub.counter("episodes_drained")
    hub.counter("episodes_drained", 2.0)
    hub.counter("sim_drops_total", 3, reason="TTL")
    hub.counter("recoveries", site="dispatch", action="retry")
    hub.gauge("sps", 12.5)
    hub.gauge("topology_return", -3.25, topology="abilene")
    hub.gauge("grad_norm", 0.125, layer="actor/MLP_0")
    rng = np.random.default_rng(0)
    for v in rng.normal(size=300):
        hub.observe("phase_s", float(v), phase="dispatch")
    for v in rng.uniform(size=7):
        hub.observe("phase_s", float(v), phase="drain")
    for i in range(5):
        hub.series("sps", 10.0 + i, ts=1000.0 + i)
        hub.series("td_abs_mean", 0.5 / (i + 1), ts=1000.5 + i,
                   topology="claranet")


def test_hub_exposition_equals_jax():
    from gsc_tpu.obs.hub import MetricsHub as JHub

    hubs = [MetricsHub(tags={"run": "r", "seed": 3}, series_window=4),
            JHub(tags={"run": "r", "seed": 3}, series_window=4)]
    for h in hubs:
        _feed(h)
    ours, theirs = hubs
    assert ours.snapshot() == theirs.snapshot()
    assert ours.histogram_summary("phase_s", phase="drain") == \
        theirs.histogram_summary("phase_s", phase="drain")
    assert ours.series_store.query() == theirs.series_store.query()
    assert ours.series_store.names() == theirs.series_store.names()
    sinks = [ListSink(), __import__("gsc_tpu.obs.sinks",
                                     fromlist=["ListSink"]).ListSink()]
    for h, s in zip(hubs, sinks):
        h.add_sink(s)
        h.event("recovery", episode=1, site="dispatch", action="retry")
    strip = lambda r: {k: v for k, v in r.items() if k != "ts"}
    assert [strip(r) for r in sinks[0].records] == \
        [strip(r) for r in sinks[1].records]


def _events():
    nan, inf = float("nan"), float("inf")
    first = [{"event": "run_start", "run": "old", "ts": 1.0},
             {"event": "episode", "episode": 0, "episodic_return": 9.0,
              "ts": 2.0}]
    second = [{"event": "run_start", "run": "r", "ts": 3.0}]
    rets = [-5.0, nan, -3.0, inf, -1.0, 0.5, 1.0, 1.5, 2.0, 2.0, 2.5, 3.0]
    for ep, r in enumerate(rets):
        topo = ("abilene", "claranet")[ep % 2]
        second.append({"event": "episode", "episode": ep,
                       "episodic_return": r, "critic_loss": 0.1 * ep,
                       "actor_loss": -0.2 * ep, "sps": 10.0 + ep,
                       "topology": topo, "ts": 4.0 + ep})
        second.append({"event": "learn_signal", "episode": ep,
                       "td_abs_mean": (nan if ep == 3 else 1.0 / (ep + 1)),
                       "q_mean": -0.5 * ep,
                       "per_topology_td": {topo: 0.3 / (ep + 1)},
                       "ts": 4.5 + ep})
    return first + second


def test_extract_curves_equals_jax():
    from gsc_tpu.obs.curves import extract_curves as j_extract

    events = _events()
    ours = extract_curves(events)
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(j_extract(events), sort_keys=True)
    assert ours["run"] == "r" and ours["episodes"] == 12
    assert set(ours["per_topology"]) == {"abilene", "claranet"}
    assert ours["series"]["episodic_return"][1] is None
    for w in (3, 50):
        assert extract_curves(events, window=w) == j_extract(events,
                                                             window=w)


def _flax_trees():
    """The tiny single-env agent's flax actor and critic parameters, and
    numpy-seeded gradients of the same structure."""
    import jax

    from test_torch_single_env import _jax_stack

    jt = _jax_stack()
    topo, traffic = jt.driver.episode(0, False)
    _, obs = jt.env.reset(jax.random.PRNGKey(0), topo, traffic)
    st = jt.ddpg.init(jax.random.PRNGKey(1), obs)
    rng = np.random.default_rng(5)
    host = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    params = {"actor": host(st.actor_params),
              "critic": host(st.critic_params)}
    grads = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    return params, grads


def test_learn_signal_matches_jax():
    import jax.numpy as jnp

    from gsc_tpu.obs.learning import LearnLedgerSpec as JSpec
    from gsc_tpu.obs.learning import emit_learn_signal as j_emit
    from gsc_tpu.obs.learning import learn_signal as j_signal

    params, grads = _flax_trees()
    rng = np.random.default_rng(11)
    td = rng.normal(size=16).astype(np.float32)
    q = rng.normal(size=16).astype(np.float32)
    topo_idx = rng.integers(0, 4, size=16).astype(np.int32)  # 3 clips to 2
    want = j_signal(JSpec(num_topos=3), jnp.asarray(topo_idx),
                    jnp.asarray(td), jnp.asarray(q), params, grads)
    conv = lambda tree: {net: params_from_jax(tree[net]) for net in tree}
    got = learn_signal(LearnLedgerSpec(num_topos=3),
                       torch.from_numpy(topo_idx), torch.from_numpy(td),
                       torch.from_numpy(q), conv(params), conv(grads))
    assert set(got) == set(want)
    for key in ("param_norms", "grad_norms"):
        assert set(got[key]) == set(want[key]) == {
            "actor/GNNEmbedder_0", "actor/MLP_0", "critic/GNNEmbedder_0",
            "critic/MLP_0"}
        for name, v in want[key].items():
            np.testing.assert_allclose(float(got[key][name]), float(v),
                                       rtol=1e-6, err_msg=f"{key} {name}")
    for key in ("td_abs_sum", "td_count", "q_mean", "q_std", "q_min",
                "q_max"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, err_msg=key)
    hubs = [MetricsHub(), __import__("gsc_tpu.obs.hub",
                                      fromlist=["MetricsHub"]).MetricsHub()]
    names = ["tri", "line", "third"]
    ours = emit_learn_signal(hubs[0], 4, signal=got, segment_names=names)
    theirs = j_emit(hubs[1], 4, signal=want, segment_names=names)
    ours.pop("ts"), theirs.pop("ts")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if isinstance(v, dict):
            assert set(ours[k]) == set(v), k
            for n, x in v.items():
                assert math.isclose(ours[k][n], x, rel_tol=1e-6), (k, n)
        elif isinstance(v, float):
            assert math.isclose(ours[k], v, rel_tol=1e-6), k
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("lead", [(), (3,)])
def test_replay_stats_match_jax(lead):
    import jax.numpy as jnp

    from gsc_tpu.agents.buffer import ReplayBuffer as JBuffer
    from gsc_tpu.obs.learning import replay_stats as j_stats

    from gsc_tpu_torch.agents.buffer import buffer_init

    size = np.array([5, 0, 8][:lead[0]] if lead else 5,
                    np.int32).reshape(lead)
    jbuf = JBuffer(data={"x": jnp.zeros(lead + (8, 2))},
                   pos=jnp.asarray(size % 8), size=jnp.asarray(size))
    tbuf = buffer_init({"x": torch.zeros(2)}, 8, lead=lead)
    tbuf.size = torch.from_numpy(size)
    got, want = replay_stats(tbuf), j_stats(jbuf)
    for k in ("size", "fill", "age_mean_steps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_select_best_agent_equals_jax(tmp_path):
    from gsc_tpu.utils.experiment import select_best_agent as j_best

    rng = np.random.default_rng(2)
    dirs = []
    for i in range(4):
        d = tmp_path / f"run{i}"
        d.mkdir()
        rows = rng.normal(size=12 + i) + (0.3 if i == 2 else 0.0)
        (d / "rewards.csv").write_text(
            "r\n" + "".join(f"{r}\n" for r in rows))
        dirs.append(str(d))
    (tmp_path / "empty").mkdir()
    dirs.append(str(tmp_path / "empty"))
    for k in (1, 10, 100):
        assert select_best_agent(dirs, last_k=k) == j_best(dirs, last_k=k)
    with pytest.raises(ValueError):
        select_best_agent([str(tmp_path / "empty")])


def test_result_yaml_reads_back():
    yaml = pytest.importorskip("yaml")
    record = {"env_config": {"agent_config": "a: b.yaml", "seed": 3,
                             "network": None},
              "runtimes": {"train": {"wall_time": 1.5e-3,
                                     "process_time": 2.0}},
              "metrics": {"mean_return": float("nan"), "ok": True,
                          "list": [1, 2.5, "x"], "empty": {}}}
    back = yaml.safe_load(to_yaml(record))
    assert math.isnan(back["metrics"].pop("mean_return"))
    record["metrics"].pop("mean_return")
    assert back == record


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_watchdog_with_an_injected_clock():
    clock = _Clock()
    hub = MetricsHub(clock=clock)
    sink = ListSink()
    hub.add_sink(sink)
    fired = []
    wd = PipelineWatchdog(hub, budget_s=10.0, start_paused=True,
                          escalate_after=2, on_escalate=fired.append)
    wd.register_probe("queue", lambda: 2)
    hub.beat("episode")
    clock.t += 50.0
    wd.poll()                         # paused: nothing
    assert sink.of_kind("stall") == []
    wd.resume()                       # beats: paused time never counts
    clock.t += 9.0
    wd.poll()
    assert sink.of_kind("stall") == []
    hub.note_phase("dispatch")
    clock.t += 2.0
    wd.poll()
    wd.poll()                         # one stall per quiet spell
    stalls = sink.of_kind("stall")
    assert len(stalls) == 1 and stalls[0]["age_s"] == 11.0
    assert stalls[0]["last_phase"] == "dispatch"
    assert stalls[0]["last_phase_state"] == "running"
    assert stalls[0]["queue"] == 2 and "note" in stalls[0]
    clock.t += 19.5                   # 30.5 s > budget * (1 + 2)
    wd.poll()
    assert fired == [30.5] and len(sink.of_kind("escalation")) == 1
    hub.beat("episode")               # re-armed
    clock.t += 10.5
    wd.poll()
    assert len(sink.of_kind("stall")) == 2 and wd.stall_count == 2
    assert hub.get_counter("stalls") == 2
    assert hub.get_counter("watchdog_escalations") == 1


def test_jsonable_takes_torch_tensors_and_device_records_on_cpu():
    rec = {"a": torch.tensor(1.5), "b": torch.arange(3),
           "c": np.float32(2.0), "d": np.arange(2)}
    assert json.loads(json.dumps(rec, default=jsonable)) == {
        "a": 1.5, "b": [0, 1, 2], "c": 2.0, "d": [0, 1]}
    if not torch.cuda.is_available():
        assert device_memory_snapshot() == [
            {"device": "cpu", "available": False, "backend": "cpu"}]


def test_metrics_endpoint_serves_the_snapshot():
    hub = MetricsHub(series_window=8)
    hub.gauge("sps", 4.0)
    hub.series("sps", 4.0, ts=5.0)
    ep = MetricsEndpoint(hub, port=0).start()
    try:
        base = f"http://127.0.0.1:{ep.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert b"gsc_sps 4.0" in text
        doc = json.loads(urllib.request.urlopen(
            base + "/series?name=sps", timeout=10).read())
        assert doc["series"] == {"gsc_sps": [[5.0, 4.0]]}
    finally:
        ep.stop()
