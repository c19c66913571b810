"""The port's runtime sentinels (``gsc_tpu_torch.analysis.sentinels``),
held to the contracts of the JAX package's (tests/test_analysis.py):

- ``no_host_sync`` trips on a value read (``.item()``, ``float()``,
  ``bool()``), names the region, passes a dispatch-only region, leaves
  no mode behind and ignores other threads;
- ``compile`` events come from the build and load hooks of
  ``ops.build`` (a fake ``nvcc`` and loader here: the CPU has neither)
  and from the plugin header generation, land in ``events.jsonl`` with
  ``fn``/``stage``/``duration_s``/``count`` and are read by
  ``tools/obs_report.py``;
- ``assert_no_retrace`` passes on a second training run in the same
  process and trips on a forced load;
- on the card (``cuda`` marker, decided inside each test): the
  sync-debug path trips on copies to the host and data-dependent shapes
  and restores the mode; the ledger's profiler launch counts equal the
  kernel wrappers' posts, also where the capture settles its held inputs
  mid-call.

No module-level JAX import: ``python -m pytest --noconftest
tests/test_torch_sentinels.py -m cuda`` runs on the card's machine.
"""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from gsc_tpu_torch.analysis import (CompileMonitor, HostSyncError,
                                    RetraceError, assert_no_retrace,
                                    no_host_sync)
from gsc_tpu_torch.ops import build
from gsc_tpu_torch.ops.gat_attention import SOURCE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------ host-sync sentinel
@pytest.mark.parametrize("read", ["item", "float", "bool"])
def test_no_host_sync_trips_on_value_reads(read):
    x = torch.arange(4.0)
    body = {"item": lambda: x.sum().item(), "float": lambda: float(x[1]),
            "bool": lambda: bool(x.any())}[read]
    with pytest.raises(HostSyncError, match="test region"):
        with no_host_sync("test region"):
            body()
    # the tripwire is gone after the region
    assert torch._C._len_torch_dispatch_stack() == 0
    body()


def test_no_host_sync_passes_a_dispatch_only_region():
    x = torch.arange(4.0)
    with no_host_sync("dispatch only"):
        y = torch.relu(x * 2 - 1).cumsum(0)
    assert float(y[-1]) == 9.0


def test_no_host_sync_guards_its_own_thread_only():
    x = torch.arange(4.0)
    got = []
    with no_host_sync("main thread"):
        t = threading.Thread(target=lambda: got.append(x.sum().item()))
        t.start()
        t.join()
    assert got == [6.0]


# --------------------------------------------------------- compile monitor
@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """``ops.build`` with a stand-in nvcc (writes the library file) and
    loader (returns the path): builds and loads happen, nothing runs.
    The native traffic sampler loads for real first: the stand-ins
    replace ``subprocess.run`` and ``ctypes.CDLL`` process-wide."""
    from gsc_tpu_torch.native import load_library

    load_library()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("not a library")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    return tmp_path


def test_compile_events_from_build_and_load_hooks(fake_toolchain):
    from gsc_tpu_torch.obs import RunObserver
    from gsc_tpu_torch.ops.resource_codegen import kernel_plan
    from gsc_tpu_torch.sim import cases

    out = fake_toolchain / "obs"
    obs = RunObserver(str(out), run_id="compile-test")
    obs.start()
    try:
        lib, log = build.build_library(SOURCE)          # built, loaded
        assert log == "ptxas info"
        build.build_library(SOURCE)                     # loaded again
        _, header = kernel_plan(list(cases.PLUGINS.values()))
        assert header is not None
    finally:
        obs.close()
    with open(out / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert events[0]["event"] == "run_start"
    assert events[0]["compile_events"] is True
    compiles = [e for e in events if e["event"] == "compile"]
    stem = os.path.splitext(os.path.basename(lib))[0]
    assert stem.startswith("gat_attention_")
    assert [(e["fn"], e["stage"], e["count"]) for e in compiles[:3]] == [
        (stem, "build", 1), (stem, "load", 1), (stem, "load", 2)]
    assert compiles[3]["fn"].startswith("resource_plugins_") \
        and compiles[3]["stage"] == "build"
    assert all({"fn", "stage", "duration_s", "count"} <= set(e)
               and e["duration_s"] >= 0 for e in compiles)
    assert obs.compile_monitor.snapshot()[stem] == (1, 2)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import obs_report
    summary = obs_report.summarize(obs_report.load_events(str(out)))
    assert stem in summary["compiles"]["per_fn"]


def test_monitor_watches_the_named_sources_only(fake_toolchain):
    mon = CompileMonitor(watch=["substep_megakernel"])
    with mon:
        build.build_library(SOURCE)
    assert mon.snapshot() == {} and not mon.events
    with CompileMonitor(watch=None) as every:
        build.build_library(SOURCE)
    assert list(every.snapshot().values()) == [(0, 1)]


def test_assert_no_retrace_passes_a_second_run_and_trips_on_a_load(
        fake_toolchain):
    from test_torch_single_env import _port_stack

    trainer = _port_stack()
    build.build_library(SOURCE)
    state, buffer = trainer.train(2)
    # the steady state: a second run builds and loads nothing
    with assert_no_retrace():
        trainer.train(3, init_state=state, init_buffer=buffer,
                      start_episode=2)
    with pytest.raises(RetraceError, match="gat_attention"):
        with assert_no_retrace("gat_attention"):
            build.build_library(SOURCE)
    # a library outside the guard's names does not trip it
    with assert_no_retrace("substep_megakernel"):
        build.build_library(SOURCE)


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_no_host_sync_on_the_card_trips_on_copies_and_restores_the_mode():
    dev = _card()
    y = torch.arange(8.0, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    for what, body in (("cpu", lambda: y.cpu()),
                       ("nonzero", lambda: y.nonzero()),
                       ("item", lambda: y.sum().item())):
        with pytest.raises(HostSyncError, match=what):
            with no_host_sync(what):
                body()
        assert torch.cuda.get_sync_debug_mode() == before
    with no_host_sync("dispatch only"):
        z = y * 2 + 1
    assert float(z[-1]) == 15.0


@pytest.mark.cuda
def test_capture_launch_counts_match_the_wrappers_on_the_card():
    from gsc_tpu_torch.obs.perf import CostLedger
    from gsc_tpu_torch.ops.cost import (attention_backward_work,
                                        attention_work)
    from gsc_tpu_torch.ops.gat_attention import gat_attention

    dev = _card()
    g = torch.Generator().manual_seed(0)
    b, n, f = 8, 24, 22
    x, xr = (torch.randn(b, n, f, generator=g).to(dev) for _ in range(2))
    att, bias = (torch.randn(f, generator=g).to(dev) for _ in range(2))
    adj = (torch.rand(b, n, n, generator=g) < 0.3).to(dev)
    w = torch.randn(f, f, generator=g).to(dev).requires_grad_(True)

    def step():
        y = gat_attention(x @ w, xr, att, bias, adj)
        torch.autograd.grad(y.sum(), [w])
        return float(y.sum())

    step()
    led = CostLedger()
    led.capture("step", step, device=dev)
    e = led.entry("step")
    kinds = e["launches"]["by_kind"]
    assert kinds["gat_attention"] == e["kernels"]["gat_attention"][
        "launches"] == 1
    assert kinds["gat_attention_backward"] == e["kernels"][
        "gat_attention_backward"]["launches"] == 1
    assert e["device_s"] > 0 and e["host_syncs"] >= 1
    xl = x @ w
    want = attention_work(xl, xr, att, bias, adj) \
        + attention_backward_work(xl, xl, xr, att, adj)
    got = e["kernels"]["gat_attention"]["flops"] \
        + e["kernels"]["gat_attention_backward"]["flops"]
    assert got == want.flops
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_held_inputs_settle_on_the_card_between_profile_segments(
        monkeypatch):
    """Past HOLD_BYTES (here: any) the capture settles its deferred counts
    mid-call between two profile segments: the hand kernels' launches from
    the profiler still equal the posts (the settling reductions are in no
    segment), and the counts equal those of a capture that holds every
    input to its end."""
    from gsc_tpu_torch.analysis import launches
    from gsc_tpu_torch.obs.perf import CostLedger
    from gsc_tpu_torch.ops.gat_attention import gat_attention

    dev = _card()
    g = torch.Generator().manual_seed(1)
    b, n, f = 8, 24, 22
    x, xr = (torch.randn(b, n, f, generator=g).to(dev) for _ in range(2))
    att, bias = (torch.randn(f, generator=g).to(dev) for _ in range(2))
    adjs = [(torch.rand(b, n, n, generator=g) < 0.3).to(dev)
            for _ in range(4)]
    w = torch.randn(f, f, generator=g).to(dev).requires_grad_(True)

    def steps():
        for adj in adjs:
            y = gat_attention(x @ w, xr, att, bias, adj.clone())
            torch.autograd.grad(y.sum(), [w])

    steps()
    entries = []
    for hold in (launches.HOLD_BYTES, 0):
        monkeypatch.setattr(launches, "HOLD_BYTES", hold)
        led = CostLedger()
        led.capture("steps", steps, device=dev)
        entries.append(led.entry("steps"))
    for e in entries:
        kinds = e["launches"]["by_kind"]
        for k in ("gat_attention", "gat_attention_backward"):
            assert kinds[k] == e["kernels"][k]["launches"] == 4
    held, settled = entries
    assert settled["kernels"] == held["kernels"]
    assert settled["flops"] == held["flops"]
    assert settled["bytes_accessed"] == held["bytes_accessed"]
    assert torch.cuda.get_sync_debug_mode() == 0
