"""The port's micro-batcher in both modes (``gsc_tpu_torch.serve.batcher``),
mirroring tests/test_fleet.py's batcher tests with numpy stub backends:
continuous answers bit-identical to deadline for a serial client, backlog
folding, drain on stop, no wedge under overload, honest backpressure,
the completion stamp written before the future's event, worker-tagged
series, the version and bucket stamped on every future, and deadline
mode's answers unchanged.  Everything compared here is exact."""
import threading
import time

import numpy as np
import pytest

from gsc_tpu_torch.obs.hub import MetricsHub
from gsc_tpu_torch.serve import (BATCH_MODES, MicroBatcher, ServeError,
                                 ServeFuture)
from torch_port_helpers import ArrayTemplate, one_torch_thread  # noqa: F401


def _obs(value=0.0, dim=3):
    return np.full(dim, value, np.float32)


def _echo_run(leaves, k, bucket):
    """Answer = 2x the request: input-dependent, so comparing modes
    means something."""
    return np.asarray(leaves[0], np.float32) * 2.0


def test_completion_stamp_written_before_event_set():
    t = ArrayTemplate(_obs())
    for run, version, fails in ((_echo_run, 7, False),
                                (lambda *a: 1 / 0, 9, True)):
        mb = MicroBatcher(run, t, buckets=(1,), version_provider=lambda v=version: v)
        fut = ServeFuture()
        fut.t_admitted = time.perf_counter()
        seen = {}
        orig = fut._event.set

        def checked(fut=fut, seen=seen, orig=orig):
            seen.update(t=fut.t_completed, v=fut.policy_version,
                        b=fut.bucket)
            orig()

        fut._event.set = checked
        mb._flush([(fut, t.flatten(_obs(1.5)))])
        if fails:
            with pytest.raises(ServeError):
                fut.result(5)
        else:
            np.testing.assert_array_equal(fut.result(5), _obs(3.0))
        assert seen["t"] is not None and seen["v"] == version \
            and seen["b"] == 1


def test_continuous_serial_client_bit_identical_to_deadline():
    t = ArrayTemplate(_obs())
    results = {}
    for mode in BATCH_MODES:
        calls = []

        def run(leaves, k, bucket, _calls=calls):
            _calls.append((k, bucket))
            return _echo_run(leaves, k, bucket)

        mb = MicroBatcher(run, t, buckets=(1, 4), deadline_ms=5.0,
                          mode=mode).start()
        try:
            outs = [np.asarray(mb.submit(_obs(float(i))).result(30))
                    for i in range(6)]
        finally:
            mb.stop()
        results[mode] = (calls, outs)
    assert results["deadline"][0] == results["continuous"][0] \
        == [(1, 1)] * 6
    for a, b in zip(results["deadline"][1], results["continuous"][1]):
        np.testing.assert_array_equal(a, b)


def test_continuous_backlog_folds_while_in_flight():
    t = ArrayTemplate(_obs())
    calls = []

    def slow_run(leaves, k, bucket):
        calls.append((k, bucket))
        time.sleep(0.02)
        return np.zeros((bucket, 3), np.float32)

    # a deadline that would take 9 x 5 s if continuous mode waited on it
    mb = MicroBatcher(slow_run, t, buckets=(1, 8), deadline_ms=5000.0,
                      mode="continuous").start()
    try:
        t0 = time.perf_counter()
        futs = [mb.submit(_obs()) for _ in range(9)]
        for f in futs:
            f.result(30)
        wall = time.perf_counter() - t0
    finally:
        mb.stop()
    assert sum(k for k, _ in calls) == 9
    assert len(calls) <= 4, calls
    assert wall < 2.0, wall


def test_continuous_stop_drains_then_rejects():
    hub = MetricsHub()
    t = ArrayTemplate(_obs())

    def slow_run(leaves, k, bucket):
        time.sleep(0.01)
        return np.zeros((bucket, 3), np.float32)

    mb = MicroBatcher(slow_run, t, buckets=(1, 4), mode="continuous",
                      hub=hub).start()
    futs = [mb.submit(_obs()) for _ in range(5)]
    mb.stop()
    for f in futs:
        assert f.result(5).shape == (3,)
    with pytest.raises(ServeError, match="stopping"):
        mb.submit(_obs())
    # counted before the error reached the caller
    assert hub.get_counter("serve_rejected_total", reason="stopping") == 1


def test_continuous_overload_never_wedges():
    t = ArrayTemplate(_obs())

    def slow(leaves, k, bucket):
        time.sleep(0.002)
        return np.zeros((bucket, 3), np.float32)

    mb = MicroBatcher(slow, t, buckets=(1, 2), deadline_ms=1.0,
                      mode="continuous", max_queue=4).start()
    failures, served = [], []

    def client(n):
        for _ in range(n):
            try:
                fut = mb.submit(_obs())
            except ServeError:
                continue          # backpressure is fine, a hang is not
            try:
                fut.result(15)
                served.append(1)
            except Exception as e:  # noqa: BLE001 - asserted below
                failures.append(e)

    threads = [threading.Thread(target=client, args=(25,))
               for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    try:
        assert not [th for th in threads if th.is_alive()], "wedged"
        assert not failures, failures[:3]
        assert served
    finally:
        mb.stop()


def test_continuous_backpressure_and_honest_depth():
    t = ArrayTemplate(_obs())
    release = threading.Event()

    def gated(leaves, k, bucket):
        release.wait(20)
        return np.zeros((bucket, 3), np.float32)

    mb = MicroBatcher(gated, t, buckets=(1, 2), deadline_ms=1.0,
                      mode="continuous", max_queue=6).start()
    try:
        futs = [mb.submit(_obs()) for _ in range(6)]
        time.sleep(0.05)
        assert mb.queue_depth >= 3, mb.queue_depth
        with pytest.raises(ServeError, match="queue full"):
            for _ in range(8):
                mb.submit(_obs())
    finally:
        release.set()
        for f in futs:
            f.result(30)
        mb.stop()
    assert mb.queue_depth == 0


def test_batcher_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        MicroBatcher(_echo_run, ArrayTemplate(_obs()), mode="sometimes")


@pytest.mark.parametrize("mode", BATCH_MODES)
def test_worker_tagged_metrics_and_version_stamp(mode):
    hub = MetricsHub()
    t = ArrayTemplate(_obs())
    version = {"v": 3}
    mb = MicroBatcher(_echo_run, t, buckets=(1,), deadline_ms=1.0,
                      hub=hub, worker="w7", mode=mode,
                      version_provider=lambda: version["v"]).start()
    try:
        f1 = mb.submit(_obs())
        f1.result(30)
        version["v"] = 4
        f2 = mb.submit(_obs())
        f2.result(30)
    finally:
        mb.stop()
    assert (f1.policy_version, f2.policy_version) == (3, 4)
    assert (f1.bucket, f2.bucket) == (1, 1)
    assert hub.get_counter("serve_requests_total", worker="w7") == 2
    assert hub.get_counter("serve_batches_total", worker="w7") == 2
    assert hub.get_counter("serve_requests_total") == 2
    assert hub.get_gauge("serve_queue_depth", worker="w7") == 0
    assert hub.get_gauge("serve_queue_depth") is None


def test_queue_depth_sampled_on_submit():
    hub = MetricsHub()
    release = threading.Event()

    def gated(leaves, k, bucket):
        release.wait(20)
        return np.zeros((bucket, 3), np.float32)

    mb = MicroBatcher(gated, ArrayTemplate(_obs()), buckets=(1,),
                      deadline_ms=1.0, hub=hub).start()
    try:
        futs = [mb.submit(_obs()) for _ in range(3)]
        # sampled at each submit, before any flush finished
        assert hub.get_gauge("serve_queue_depth") >= 2
    finally:
        release.set()
        for f in futs:
            f.result(30)
        mb.stop()


def test_deadline_mode_pads_and_slices_as_before():
    """Deadline mode: a burst of 3 within the deadline is one bucket-4
    call padded with the last request, sliced back per request."""
    t = ArrayTemplate(_obs())
    calls = []
    gate = threading.Event()

    def run(leaves, k, bucket):
        gate.wait(5)
        calls.append((k, bucket, leaves[0].copy()))
        return _echo_run(leaves, k, bucket)

    mb = MicroBatcher(run, t, buckets=(1, 4), deadline_ms=200.0).start()
    try:
        futs = [mb.submit(_obs(float(i))) for i in range(3)]
        gate.set()
        outs = [f.result(30) for f in futs]
    finally:
        mb.stop()
    assert [(k, b) for k, b, _ in calls] == [(3, 4)]
    np.testing.assert_array_equal(calls[0][2][3], _obs(2.0))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, _obs(2.0 * i))
