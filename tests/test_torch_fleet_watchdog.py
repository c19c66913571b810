"""The async fleet's per-thread watchdog (``obs.watchdog``
``PipelineWatchdog.watch_thread``, ``obs.run.RunObserver.watch_fleet``)
and its wiring into ``Trainer.train_async``: the port's counterparts of
tests/test_flight.py:150-195.

- a thread registered with a 0.05 s budget and left quiet gives exactly
  one ``stall`` event naming it and its last phase, and
  ``thread_stalls{thread=}`` 1, while a thread that beats gives none; it
  re-arms on its next beat (driven through an injected clock and explicit
  polls, no wall sleeps against a budget);
- ``train --async`` with a ``watcher_stall`` fault that holds actor 1 in
  its adoption for 2 s (the watchdog's budget 0.5 s) registers
  ``actor0``, ``actor1`` and ``learner``, gives a stall event naming
  ``actor1`` in phase ``adopt``, and unregisters the fleet at the end.
"""
import pytest

from gsc_tpu_torch import cli
from gsc_tpu_torch.obs.hub import MetricsHub
from gsc_tpu_torch.obs.run import RunObserver
from gsc_tpu_torch.obs.sinks import ListSink
from gsc_tpu_torch.obs.watchdog import PipelineWatchdog
from test_torch_single_env import TINY_AGENT, TINY_SIM
from torch_port_helpers import one_torch_thread  # noqa: F401


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_quiet_thread_gives_one_stall_naming_it_and_its_phase():
    clock = Clock()
    hub = MetricsHub(clock=clock)
    sink = ListSink()
    hub.add_sink(sink)
    wd = PipelineWatchdog(hub, budget_s=30.0, clock=clock)
    hub.beat("episode")
    wd.watch_thread("learner", budget_s=5.0)
    wd.watch_thread("actor1", budget_s=0.05)
    assert wd.watched_threads() == ["actor1", "learner"]
    hub.note_thread_phase("actor1", "blocked_put")
    hub.note_thread_phase("learner", "ingest")
    for _ in range(4):
        clock.now += 0.03
        hub.beat("learner")
        wd.poll()
    stalls = sink.of_kind("stall")
    assert len(stalls) == 1
    s = stalls[0]
    assert s["thread"] == "actor1" and s["last_phase"] == "blocked_put"
    assert s["budget_s"] == 0.05 and s["age_s"] > 0.05
    assert s["thread_phases"]["learner"] == "ingest"
    assert hub.get_counter("thread_stalls", thread="actor1") == 1
    assert hub.get_counter("thread_stalls", thread="learner") == 0
    # re-armed by the thread's next beat, then quiet again: one more
    hub.beat("actor1")
    wd.poll()
    clock.now += 0.1
    wd.poll()
    assert len(sink.of_kind("stall")) == 2
    assert hub.get_counter("thread_stalls", thread="actor1") == 2
    wd.unwatch_thread("actor1")
    wd.unwatch_all_threads()
    assert wd.watched_threads() == []


def test_fleet_watch_through_the_observer():
    clock = Clock()
    obs = RunObserver(None, watchdog_budget_s=1.0, clock=clock)
    obs.watch_fleet(["actor0", "learner"], budget_s=0.5)
    assert obs.watchdog.watched_threads() == ["actor0", "learner"]
    obs.watchdog.resume()
    clock.now += 0.6
    obs.hub.beat("learner")
    obs.hub.beat("episode")
    obs.watchdog.poll()
    assert [e["thread"] for e in obs.events.of_kind("stall")] == ["actor0"]
    obs.unwatch_fleet()
    assert obs.watchdog.watched_threads() == []
    assert RunObserver(None).watch_fleet(["actor0"]) is None


@pytest.mark.parametrize("fault", ["watcher_stall@a1:1:2.0"])
def test_train_async_watches_its_fleet(tmp_path, monkeypatch, fault):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT.replace(
        "episode_steps: 3", "episode_steps: 4"))
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    seen = []
    original = RunObserver.watch_fleet

    def spy(self, names, budget_s=None):
        seen.append(list(names))
        return original(self, names, budget_s)

    monkeypatch.setattr(RunObserver, "watch_fleet", spy)
    out = cli.run_train([
        "--device", "cpu", "--replicas", "2", "--chunk", "2",
        "--episodes", "2", "--async", "--async-actors", "2",
        "--network", "abilene",
        "--agent-config", str(tmp_path / "agent.yaml"),
        "--simulator-config", str(tmp_path / "sim.yaml"),
        "--watchdog-budget", "0.5", "--watchdog-escalate", "0",
        "--fault-plan", fault])
    obs = out["trainer"].obs
    assert seen == [["actor0", "actor1", "learner"]]
    assert obs.watchdog.watched_threads() == []
    # the held adoption is named (a slow first chunk on a loaded CPU may
    # add a stall in another phase)
    stalls = [e for e in obs.events.of_kind("stall")
              if e.get("thread") == "actor1"]
    assert [e for e in stalls if e["last_phase"] == "adopt"]
    assert obs.hub.get_counter("thread_stalls", thread="actor1") == len(
        stalls)
    assert out["summary"]["drain"]["transitions_lost"] == 0
