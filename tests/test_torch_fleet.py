"""The port's serving fleet (``gsc_tpu_torch.serve.fleet``): weight
publishing and watching, hot-swap, least-queue-depth routing with the
SPR brownout, the merged SLO, and the trainers' publisher.

Held against the JAX package exactly: ``params_fingerprint`` on the same
leaves, and a publish directory written by either package's
``WeightPublisher`` read by the other's ``read_latest``/``load_version``
(same manifest fields, same bytes).  Mirrors tests/test_fleet.py with
stub workers and numpy backends, and, with a tiny actor on the CPU, the
learned tier's swap: after a swap the answers equal a single-shot call
under the new weights bit for bit, and a mismatched version is refused
with the served weights untouched."""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from gsc_tpu_torch.config import init_configs_agent
from gsc_tpu_torch.obs import ListSink, MetricsHub, SLOEngine, parse_slo_spec
from gsc_tpu_torch.serve import (FleetDispatcher, GreedyServePolicy,
                                 PolicyServer, ServeError, ServeFuture,
                                 VersionWatcher, WeightPublisher,
                                 load_version, params_fingerprint,
                                 read_latest, run_serve)
from gsc_tpu_torch.serve.fleet import host_leaves
from torch_port_helpers import StubPolicy, one_torch_thread  # noqa: F401

TINY_AGENT = dict(gnn_impl="pallas", gnn_features=4,
                  actor_hidden_layer_nodes=(8,))


def _leaves(scale=1.0):
    return [np.full((4, 2), scale, np.float32),
            np.arange(2, dtype=np.float32) * scale,
            np.arange(6, dtype=np.int64).reshape(2, 3)]


def test_params_fingerprint_matches_jax():
    from gsc_tpu.serve.fleet import params_fingerprint as jfp

    rng = np.random.default_rng(0)
    cases = [_leaves(), [], [rng.normal(size=(3, 5)).astype(np.float32)],
             [rng.normal(size=(7,)), rng.integers(0, 9, (2, 2)),
              np.zeros((0, 3), np.float32), np.float32(3.5)]]
    for leaves in cases:
        assert params_fingerprint(leaves) == jfp(leaves)


def test_publish_directory_reads_across_packages(tmp_path):
    from gsc_tpu.serve.fleet import WeightPublisher as JaxPublisher
    from gsc_tpu.serve.fleet import load_version as jload
    from gsc_tpu.serve.fleet import read_latest as jlatest

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxPublisher(jdir).publish(_leaves(2.0), meta={"episode": 3})
    WeightPublisher(pdir, wall_clock=lambda: 5.0).publish(
        _leaves(2.0), meta={"episode": 3})
    for writer, reader in ((jdir, (read_latest, load_version)),
                           (pdir, (jlatest, jload))):
        rec = reader[0](writer)
        assert rec["version"] == 1 and rec["meta"] == {"episode": 3}
        for got, want in zip(reader[1](writer, rec), _leaves(2.0)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    j = json.load(open(os.path.join(jdir, "v00001.json")))
    p = json.load(open(os.path.join(pdir, "v00001.json")))
    assert set(j) == set(p)
    assert {k: j[k] for k in j if k != "ts"} == \
        {k: p[k] for k in p if k != "ts"}
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))


def test_publisher_versions_fingerprints_and_retention(tmp_path):
    pub = WeightPublisher(str(tmp_path), keep_versions=2)
    recs = [pub.publish(_leaves(float(i))) for i in range(1, 6)]
    assert [r["version"] for r in recs] == [1, 2, 3, 4, 5]
    again = pub.publish(_leaves(5.0))
    assert again["version"] == 6
    assert again["fingerprint"] == recs[-1]["fingerprint"]
    assert len({r["fingerprint"] for r in recs}) == 5
    assert sorted(os.listdir(str(tmp_path))) == [
        "latest.json", "v00005.json", "v00005.npz", "v00006.json",
        "v00006.npz"]
    latest = read_latest(str(tmp_path))
    assert latest["version"] == 6
    assert params_fingerprint(load_version(str(tmp_path), latest)) \
        == again["fingerprint"]
    assert WeightPublisher(str(tmp_path)).publish(_leaves())["version"] == 7
    # a module and its state dict publish the same leaves
    lin = torch.nn.Linear(3, 2)
    assert pub.publish(lin)["fingerprint"] == \
        pub.publish(lin.state_dict())["fingerprint"] == \
        params_fingerprint([p.detach().numpy() for p in
                            lin.state_dict().values()])


def test_publish_refuses_non_finite_and_injects_corruption(tmp_path):
    from gsc_tpu_torch.resilience.faults import FaultPlan

    hub = MetricsHub()
    plan = FaultPlan.parse("publish_corrupt@v2")
    pub = WeightPublisher(str(tmp_path), hub=hub, fault_plan=plan)
    bad = _leaves()
    bad[0][0, 0] = np.nan
    assert pub.publish(bad) is None and pub.version == 0
    assert hub.get_counter("weight_publish_skipped_total") == 1
    inbox = []
    pub.subscribe(lambda rec, leaves: inbox.append(leaves))
    big = lambda s: [np.full((64, 64), s, np.float32)]   # bytes mid-blob
    pub.publish(big(1.0))
    rec2 = pub.publish(big(2.0))           # v2: corrupted in flight
    with pytest.raises(ValueError, match="unreadable|fingerprint"):
        load_version(str(tmp_path), rec2)
    assert np.isnan(inbox[1][0]).all() and np.isfinite(inbox[0][0]).all()


def test_read_latest_tolerates_missing_and_torn(tmp_path):
    assert read_latest(str(tmp_path)) is None
    with open(os.path.join(str(tmp_path), "latest.json"), "w") as f:
        f.write('{"version": ')
    assert read_latest(str(tmp_path)) is None
    with open(os.path.join(str(tmp_path), "latest.json"), "w") as f:
        json.dump({"not": "a weights record"}, f)
    assert read_latest(str(tmp_path)) is None


def test_load_version_rejects_corrupt_and_mismatched(tmp_path):
    pub = WeightPublisher(str(tmp_path))
    rec = pub.publish(_leaves())
    blob = os.path.join(str(tmp_path), rec["blob"])
    with open(blob, "wb") as f:
        f.write(b"\x00not-an-npz")
    with pytest.raises(ValueError, match="unreadable"):
        load_version(str(tmp_path), rec)
    rec2 = pub.publish(_leaves(2.0))
    shutil.copy(os.path.join(str(tmp_path), rec2["blob"]), blob)
    with pytest.raises(ValueError, match="fingerprint|signature"):
        load_version(str(tmp_path), rec)


class _SwapServer:
    """A duck-typed server for watcher tests: records the swaps."""

    def __init__(self):
        self.policy_version = 0
        self.applied = []

    def apply_weights(self, leaves, version, fingerprint, meta=None):
        self.applied.append((version, fingerprint))
        self.policy_version = version


def test_version_watcher_applies_once_retries_bounded(tmp_path):
    pub = WeightPublisher(str(tmp_path))
    srv = _SwapServer()
    hub = MetricsHub()
    watcher = VersionWatcher(str(tmp_path), srv, hub=hub, max_retries=2)
    assert watcher.poll_once() is False
    rec = pub.publish(_leaves())
    assert watcher.poll_once() is True
    assert watcher.poll_once() is False
    assert srv.applied == [(1, rec["fingerprint"])]
    rec2 = pub.publish(_leaves(2.0))
    with open(os.path.join(str(tmp_path), rec2["blob"]), "wb") as f:
        f.write(b"garbage")
    for _ in range(4):
        assert watcher.poll_once() is False
    assert hub.get_counter("serve_swap_failed_total") == 2   # parked
    assert srv.policy_version == 1
    pub.publish(_leaves(3.0))
    assert watcher.poll_once() is True and srv.policy_version == 3
    # a torn blob fixed between polls swaps on the retry
    rec4 = pub.publish(_leaves(4.0))
    blob4 = os.path.join(str(tmp_path), rec4["blob"])
    real = open(blob4, "rb").read()
    with open(blob4, "wb") as f:
        f.write(b"half-written")
    assert watcher.poll_once() is False
    with open(blob4, "wb") as f:
        f.write(real)
    assert watcher.poll_once() is True and srv.policy_version == 4


def test_in_process_watcher_refuses_poisoned_version():
    from gsc_tpu_torch.resilience.faults import FaultPlan

    pub = WeightPublisher(None, fault_plan=FaultPlan.parse(
        "publish_corrupt@v2"))
    srv = _SwapServer()
    watcher = VersionWatcher(None, srv, publisher=pub, max_retries=1)
    pub.publish(_leaves(1.0))
    assert watcher.poll_once() is True and srv.policy_version == 1
    pub.publish(_leaves(2.0))               # NaN leaves in flight
    assert watcher.poll_once() is False and srv.policy_version == 1
    pub.publish(_leaves(3.0))
    assert watcher.poll_once() is True and srv.policy_version == 3
    watcher.stop()
    assert not pub.subscribers


def test_spr_tier_swap_stream_matches_stamped_version(tmp_path):
    """A request stream across three swaps: every answer equals the
    action of the version stamped on it."""
    hub = MetricsHub()
    sink = ListSink()
    hub.add_sink(sink)
    srv = PolicyServer(fallback=StubPolicy(answer=np.arange(4.0)),
                       buckets=(1, 4), deadline_ms=1.0, hub=hub,
                       mode="continuous", hot_swap_dir=str(tmp_path),
                       swap_poll_s=60.0).start()
    versions = {0: np.asarray(srv.fallback.action)}
    pub = WeightPublisher(str(tmp_path), hub=hub)
    answers = []
    lock = threading.Lock()

    def client(n):
        for _ in range(n):
            fut = srv.submit(np.zeros(3, np.float32))
            out = np.asarray(fut.result(30))
            with lock:
                answers.append((fut.policy_version, out))

    try:
        threads = [threading.Thread(target=client, args=(10,))
                   for _ in range(3)]
        for th in threads:
            th.start()
        for v in (1, 2, 3):
            versions[v] = (versions[0] * (v + 1)).astype(np.float32)
            pub.publish([versions[v]])
            for _ in range(5):
                srv.watcher.poll_once()
                time.sleep(0.002)
        for th in threads:
            th.join()
    finally:
        srv.close()
    assert len(answers) == 30
    for v, out in answers:
        np.testing.assert_array_equal(out, versions[v])
    swaps = sink.of_kind("weight_swap")
    assert srv.policy_version == 3 and [s["version"] for s in swaps] \
        == [1, 2, 3]
    assert all(s["weights_applied"] for s in swaps)
    assert hub.get_counter("serve_errors_total") == 0


@pytest.fixture(scope="module")
def learned():
    report = run_serve(agent=init_configs_agent(**TINY_AGENT), device="cpu",
                       pool_steps=2, requests=1, concurrency=1,
                       seeded_actor=True)
    return report.ddpg, report.pool


def _single_shot(ddpg, leaves, obs):
    from gsc_tpu_torch.env.observations import GraphObs

    actor = GreedyServePolicy(ddpg, obs).stage(leaves)
    batch = GraphObs(**{k: torch.from_numpy(np.asarray(v))[None]
                        for k, v in vars(obs).items()})
    return ddpg.greedy_action(batch, actor=actor)[0].numpy()


def test_learned_tier_swap_bit_identical_to_single_shot(learned, tmp_path):
    ddpg, pool = learned
    policy = GreedyServePolicy(ddpg, pool[0])
    v0 = policy.leaves()
    v1 = [l + np.float32(1e-2) for l in v0]
    pub = WeightPublisher(str(tmp_path))
    srv = PolicyServer(policy, buckets=(1, 2), deadline_ms=1.0,
                       mode="continuous", hot_swap_dir=str(tmp_path),
                       swap_poll_s=60.0, hub=MetricsHub()).start()
    try:
        a0 = [srv.submit_sync(o, timeout=60) for o in pool]
        pub.publish(v1, meta={"episode": 7})
        assert srv.watcher.poll_once() is True and srv.policy_version == 1
        a1 = [srv.submit_sync(o, timeout=60) for o in pool]
    finally:
        srv.close()
    for o, got0, got1 in zip(pool, a0, a1):
        np.testing.assert_array_equal(got0, _single_shot(ddpg, v0, o))
        np.testing.assert_array_equal(got1, _single_shot(ddpg, v1, o))
    assert not np.array_equal(a0[0], a1[0]), "the swap test is vacuous"
    # the agent's own actor is not the served one: it never moved
    for got, want in zip(host_leaves(ddpg.actor), v0):
        np.testing.assert_array_equal(got, want)


def test_learned_tier_rejects_mismatched_swap(learned, tmp_path):
    ddpg, pool = learned
    policy = GreedyServePolicy(ddpg, pool[0])
    srv = PolicyServer(policy, buckets=(1,), deadline_ms=1.0,
                       hot_swap_dir=str(tmp_path), swap_poll_s=60.0,
                       hub=MetricsHub()).start()
    try:
        before = srv.submit_sync(pool[0], timeout=60)
        pub = WeightPublisher(str(tmp_path))
        pub.publish([np.zeros((3, 3), np.float32)])       # wrong leaves
        assert srv.watcher.poll_once() is False
        wrong = [l.astype(np.float64) for l in policy.leaves()]
        pub.publish(wrong)                                # wrong dtypes
        assert srv.watcher.poll_once() is False
        assert srv.policy_version == 0
        np.testing.assert_array_equal(
            srv.submit_sync(pool[0], timeout=60), before)
        pub.publish(policy.leaves())
        assert srv.watcher.poll_once() is True and srv.policy_version == 3
    finally:
        srv.close()


class _StubWorker:
    def __init__(self, name, depth=0, burn=None, full=False):
        self.worker = name
        self._depth = depth
        self.full = full
        self.submitted = []
        self._completed = 0
        self.policy_version = 0
        self.swaps = 0
        self._occupancy = {}
        self.slo_engine = None
        if burn is not None:
            class _Engine:
                def snapshot(self, _burn=burn):
                    return {"burn_rate": _burn}
            self.slo_engine = _Engine()

    @property
    def queue_depth(self):
        return self._depth

    def submit(self, obs):
        if self.full:
            raise ServeError("serve queue full")
        self.submitted.append(obs)
        fut = ServeFuture()
        fut._result = np.zeros(1, np.float32)
        fut.t_completed = time.perf_counter()
        fut._event.set()
        return fut


def test_dispatcher_routes_least_queue_depth():
    w0, w1, w2 = (_StubWorker("w0", 3), _StubWorker("w1", 1),
                  _StubWorker("w2", 2))
    fleet = FleetDispatcher([w0, w1, w2], brownout_burn=None)
    for _ in range(3):
        fleet.submit(np.zeros(3))
    assert [len(w.submitted) for w in (w0, w1, w2)] == [0, 3, 0]
    w1._depth = 9
    fleet.submit(np.zeros(3))
    assert len(w2.submitted) == 1
    w0._depth = w2._depth = 1            # a tie goes to the first worker
    fleet.submit(np.zeros(3))
    assert len(w0.submitted) == 1


def test_dispatcher_sheds_overflow_and_burn_to_spr():
    hub = MetricsHub()
    spr = _StubWorker("spr")
    full = _StubWorker("w0", depth=0, full=True)
    FleetDispatcher([full], spr=spr, hub=hub,
                    brownout_burn=None).submit(np.zeros(3))
    assert len(spr.submitted) == 1
    assert hub.get_counter("serve_brownout_total", reason="overflow") == 1
    now = {"t": 0.0}
    burning = _StubWorker("w1", depth=4, burn=5.0)
    fleet = FleetDispatcher([burning], spr=spr, hub=hub, brownout_burn=2.0,
                            burn_refresh_s=1.0, clock=lambda: now["t"])
    fleet.submit(np.zeros(3))
    assert len(burning.submitted) == 0 and len(spr.submitted) == 2
    assert hub.get_counter("serve_brownout_total", reason="slo_burn") == 1
    burning._depth = 0                   # no backlog: burn alone keeps it
    fleet.submit(np.zeros(3))
    assert len(burning.submitted) == 1
    # the burn is read at the refresh cadence of the injected clock
    burning._depth = 4
    burning.slo_engine.snapshot = lambda: {"burn_rate": 0.5}
    fleet.submit(np.zeros(3))
    assert len(spr.submitted) == 3       # still the cached 5.0
    now["t"] = 2.0
    fleet.submit(np.zeros(3))
    assert len(burning.submitted) == 2   # refreshed: 0.5 < 2.0
    with pytest.raises(ServeError):
        FleetDispatcher([full], brownout_burn=None).submit(np.zeros(3))


def test_dispatcher_merged_slo_weights_by_volume():
    def engine(n_hits, n_miss):
        e = SLOEngine(deadline_ms=5.0, objectives=parse_slo_spec("10"))
        for _ in range(n_hits):
            e.record_request(1.0, 1)
        for _ in range(n_miss):
            e.record_request(50.0, 1)
        e.record_flush(1, 2)
        return e

    w0, w1 = _StubWorker("w0"), _StubWorker("w1")
    w0.slo_engine, w1.slo_engine = engine(9, 1), engine(2, 2)
    doc = FleetDispatcher([w0, w1], brownout_burn=None).merged_slo()
    assert doc["requests"] == 14 and doc["deadline_misses"] == 3
    assert abs(doc["attainment"] - (0.9 * 10 + 0.5 * 4) / 14) < 1e-6
    assert doc["burn_rate"] == round((1 - doc["attainment"]) / 0.01, 4)
    assert doc["pad_waste"] == 0.5
    assert set(doc["per_worker"]) == {"w0", "w1"}


def _tiny_trainer(tmp_path, replicas):
    from gsc_tpu_torch import cli

    agent = tmp_path / "agent.yaml"
    agent.write_text(
        "GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
        "episode_steps: 2\nactor_hidden_layer_nodes: [8]\n"
        "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
        "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
    return ["--device", "cpu", "--agent-config", str(agent), "--replicas",
            str(replicas), "--chunk", "1", "--episodes", "2"], cli


@pytest.mark.parametrize("replicas", [1, 2])
def test_trainer_publisher_feeds_version_watcher(tmp_path, replicas):
    """Both trainers publish once per episode, and a watcher adopts the
    trainer's final actor (the verified snapshot on one env, the
    host-checked replica state on B)."""
    args, cli = _tiny_trainer(tmp_path, replicas)
    out = cli.run_train(args + ["--hot-swap-dir", str(tmp_path / "w"),
                                "--publish-interval", "1"])
    srv = _SwapServer()
    watcher = VersionWatcher(str(tmp_path / "w"), srv, hub=MetricsHub())
    assert watcher.poll_once() is True
    version, fingerprint = srv.applied[-1]
    assert version == 2 and read_latest(str(tmp_path / "w"))["meta"] \
        == {"episode": 2}
    assert fingerprint == params_fingerprint(host_leaves(out["state"].actor))
