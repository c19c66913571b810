"""Serving fleet: train-while-serve weight hot-swap and multi-worker
dispatch.

The port of ``gsc_tpu.serve.fleet`` without the artifact-cache pruning
hook (the port has no artifact cache):

- :class:`WeightPublisher` — the training side.  Writes versioned,
  fingerprinted weight artifacts into a directory: one ``v<NNNNN>.npz``
  (the leaves) and one ``v<NNNNN>.json`` manifest (version, content
  fingerprint, leaf shapes and dtypes, caller metadata) per publish, and
  an atomically rewritten ``latest.json`` pointer; every write is a temp
  file then ``os.replace``.  Old versions are pruned (``keep_versions``).
  The leaves of a torch module or state dict are its state-dict values in
  order; the layout and manifest fields are the JAX package's
  (``WEIGHTS_FORMAT = 1``), so either package reads what the other wrote.
- :class:`VersionWatcher` — the worker side.  A daemon thread polls
  ``latest.json``; a newer version is loaded, fingerprint-checked and
  handed to ``PolicyServer.apply_weights``, which swaps it in under the
  batcher's flush lock, between two dispatches.  A corrupt or mismatched
  artifact is skipped loudly, retried a bounded number of times, and the
  served weights stay as they are.
- :class:`FleetDispatcher` — N :class:`~gsc_tpu_torch.serve.server.PolicyServer`
  workers behind least-queue-depth routing, with a brownout to the SPR
  tier: when the fleet's error budget burns faster than
  ``brownout_burn`` and the least loaded worker has a backlog, or a
  worker refuses on a full queue, the request goes to the SPR tier
  instead of being refused, and ``serve_brownout_total{reason=slo_burn|
  overflow}`` counts it.

Trainer and fleet share nothing but a directory: one writer per
directory, any number of watchers.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import tempfile
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import ServeError, ServeFuture

log = logging.getLogger("gsc_tpu_torch.serve.fleet")

# weight-artifact layout version (bump on any blob/manifest change)
WEIGHTS_FORMAT = 1

_VERSION_RE = re.compile(r"^v(\d{5,})\.json$")


def _vname(version: int) -> str:
    return f"v{version:05d}"


def params_fingerprint(leaves: Sequence[np.ndarray]) -> str:
    """Content identity of a flattened param tree: sha256 over every
    leaf's shape, dtype and bytes in leaf order — the weight-artifact
    analogue of ``utils.checkpoint.checkpoint_fingerprint`` (retraining
    changes it, a republish of identical weights does not)."""
    h = hashlib.sha256()
    for leaf in leaves:
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _leaf_sig(leaves: Sequence[np.ndarray]) -> List[List]:
    return [[list(np.asarray(l).shape), str(np.asarray(l).dtype)]
            for l in leaves]


def host_leaves(params) -> List[np.ndarray]:
    """The leaves of ``params`` as host arrays: a list or tuple of arrays
    as it is, a torch module's or a state dict's values in state-dict
    order (tensors copied to the host once)."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    if isinstance(params, dict):
        params = list(params.values())
    return [l.detach().cpu().numpy() if hasattr(l, "detach")
            else np.asarray(l) for l in params]


def leaves_finite(leaves: Sequence[np.ndarray]) -> bool:
    """Every floating leaf finite (a host scan: publish cadence only)."""
    return all(np.isfinite(l).all() for l in leaves
               if np.issubdtype(l.dtype, np.floating))


class WeightPublisher:
    """Training-side writer of versioned weight artifacts.

    ``publish(params)`` takes a list of host arrays, a state dict or a
    torch module (see :func:`host_leaves`); the watcher hands the leaves
    back in the same order, which is the served actor's state-dict
    order.

    Two delivery channels, each optional: ``root``, the on-disk protocol
    above; and ``subscribers``, callables ``fn(record, leaves)`` called
    in-process after each publish with the host leaves (with
    ``root=None`` the record's ``fingerprint`` is None).  ``fault_plan``
    is the chaos hook of the ``publish_corrupt@v<N>`` site: the blob of
    version N is written with one byte flipped under a clean manifest
    (the watchers' fingerprint check must refuse it) and subscribers get
    NaN leaves.  ``wall_clock`` stamps the manifests' ``ts``."""

    def __init__(self, root: Optional[str] = None, keep_versions: int = 8,
                 hub=None, subscribers: Sequence[Callable] = (),
                 fault_plan=None, wall_clock=time.time):
        if keep_versions < 1:
            raise ValueError(f"keep_versions must be >= 1: {keep_versions}")
        self.root = None if root is None else os.path.abspath(root)
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
        self.keep_versions = int(keep_versions)
        self.hub = hub
        self.fault_plan = fault_plan
        self.wall_clock = wall_clock
        self.subscribers: List[Callable] = list(subscribers)
        self._version = (self._scan_latest_version()
                         if self.root is not None else 0)

    def subscribe(self, fn: Callable) -> Callable:
        """Attach an in-process ``fn(record, leaves)``; returns ``fn``."""
        self.subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable):
        try:
            self.subscribers.remove(fn)
        except ValueError:
            pass

    def _scan_latest_version(self) -> int:
        latest = 0
        for path in glob.glob(os.path.join(self.root, "v*.json")):
            m = _VERSION_RE.match(os.path.basename(path))
            if m:
                latest = max(latest, int(m.group(1)))
        return latest

    @property
    def version(self) -> int:
        """The last published version (0: nothing published yet)."""
        return self._version

    def publish(self, params, meta: Optional[Dict] = None,
                verified: bool = False) -> Optional[Dict]:
        """Write the next version; returns its manifest record, or None
        when a non-finite leaf refuses it (no version, no artifact, no
        subscriber call).  ``verified=True``: the caller has already
        found the leaves finite, skip the scan."""
        leaves = host_leaves(params)
        if not verified and not leaves_finite(leaves):
            log.warning("publish refused: non-finite leaves at version "
                        "%d — a poisoned version must never reach a "
                        "watcher", self._version + 1)
            if self.hub is not None:
                self.hub.counter("weight_publish_skipped_total")
                self.hub.event("weight_publish_skipped",
                               version=self._version + 1,
                               reason="non_finite")
            return None
        version = self._version + 1
        name = _vname(version)
        # injected corruption keyed by the version, after the gate above:
        # the watchers' checks are what must catch it
        corrupt = (self.fault_plan.fire("publish_corrupt", version)
                   if self.fault_plan is not None else None)
        record = {"format": WEIGHTS_FORMAT, "version": version,
                  "fingerprint": None, "blob": None, "leaves": None,
                  "ts": round(self.wall_clock(), 3), "meta": meta or {}}
        if self.root is not None:
            blob_path = os.path.join(self.root, name + ".npz")
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".npz.tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **{f"leaf_{i}": l
                                   for i, l in enumerate(leaves)})
                os.replace(tmp, blob_path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            if corrupt is not None:
                # one byte flipped mid-blob under the clean fingerprint
                with open(blob_path, "r+b") as f:
                    f.seek(os.path.getsize(blob_path) // 2)
                    b = f.read(1) or b"\x00"
                    f.seek(-len(b), os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]))
            record.update(fingerprint=params_fingerprint(leaves),
                          blob=os.path.basename(blob_path),
                          leaves=_leaf_sig(leaves))
            from ..obs.sinks import write_atomic_json
            write_atomic_json(os.path.join(self.root, name + ".json"),
                              record)
            # the pointer last: a watcher that reads it can trust the
            # blob and manifest it names
            write_atomic_json(os.path.join(self.root, "latest.json"),
                              record)
        self._version = version
        if self.root is not None:
            self._prune_versions()
        if self.hub is not None:
            self.hub.event("weight_publish", version=version,
                           fingerprint=record["fingerprint"],
                           **({"meta": meta} if meta else {}))
            self.hub.gauge("serve_published_version", version)
        deliver = leaves
        if corrupt is not None:
            deliver = [np.full_like(l, np.nan)
                       if np.issubdtype(l.dtype, np.floating) else l
                       for l in leaves]
        for sub in list(self.subscribers):
            try:   # a broken subscriber must not fail the publish
                sub(record, deliver)
            except Exception:
                log.exception("publish subscriber failed at version %d",
                              version)
        return record

    def _prune_versions(self):
        """Keep the newest ``keep_versions`` (the latest is never
        touched); a blob whose manifest is already gone — or vice versa
        (a crashed earlier prune) — still gets collected."""
        versions = sorted(
            {int(m.group(1))
             for p in glob.glob(os.path.join(self.root, "v*.json"))
             for m in [_VERSION_RE.match(os.path.basename(p))] if m}
            | {int(m.group(1))
               for p in glob.glob(os.path.join(self.root, "v*.npz"))
               for m in [re.match(r"^v(\d{5,})\.npz$",
                                  os.path.basename(p))] if m},
            reverse=True)
        for version in versions[self.keep_versions:]:
            if version == self._version:
                continue
            for suffix in (".json", ".npz"):   # manifest first: a
                # pointer-less blob is untrusted, the reverse is a
                # manifest naming a missing blob (load_version rejects
                # both, but manifest-first never exposes the second)
                try:
                    os.unlink(os.path.join(self.root,
                                           _vname(version) + suffix))
                except OSError:
                    pass


def read_latest(root: str) -> Optional[Dict]:
    """The current ``latest.json`` record; None when missing, torn or not
    describing a weights artifact (all tolerated — the watcher just polls
    again)."""
    try:
        with open(os.path.join(root, "latest.json")) as f:
            rec = json.load(f)
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if not isinstance(rec, dict) or rec.get("format") != WEIGHTS_FORMAT \
            or not isinstance(rec.get("version"), int):
        return None
    return rec


def load_version(root: str, record: Dict) -> List[np.ndarray]:
    """Load + validate one published version's leaves.  Raises
    ``ValueError`` when the blob is missing/corrupt, the leaf signature
    disagrees with the manifest, or the content fingerprint does not
    match — a watcher must never swap unverified bytes in."""
    blob_path = os.path.join(root, record["blob"])
    try:
        with np.load(blob_path) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        # BadZipFile: npz member reads are CRC-checked, so a torn or
        # bit-flipped blob can surface here before the fingerprint pass
        raise ValueError(f"weights blob unreadable: {blob_path} "
                         f"({type(e).__name__}: {e})")
    if _leaf_sig(leaves) != record.get("leaves"):
        raise ValueError(f"weights blob leaf signature does not match its "
                         f"manifest: {blob_path}")
    fp = params_fingerprint(leaves)
    if fp != record.get("fingerprint"):
        raise ValueError(f"weights blob fingerprint mismatch: {blob_path} "
                         f"(manifest {record.get('fingerprint')!r:.20} != "
                         f"content {fp!r:.20})")
    return leaves


class VersionWatcher:
    """Worker-side poller: swaps newly published versions into a running
    :class:`~gsc_tpu_torch.serve.server.PolicyServer` between dispatches.

    Two sources, mirroring the publisher's two channels:

    - ``root`` — the on-disk protocol (poll ``latest.json``, load +
      fingerprint-validate the blob);
    - ``publisher`` — an in-process :class:`WeightPublisher` this
      watcher subscribes to: each publish lands ``(record, params)`` in
      a latest-wins inbox (delivery runs in the publisher's thread and
      only stores a reference), and ``poll_once`` adopts from the inbox
      after a finite check, with no filesystem and no npz.  The apply
      path and swap discipline are the same either way."""

    def __init__(self, root: Optional[str], server, poll_s: float = 0.2,
                 hub=None, max_retries: int = 5, publisher=None):
        if root is None and publisher is None:
            raise ValueError("VersionWatcher needs a root directory or an "
                             "in-process publisher")
        self.root = None if root is None else os.path.abspath(root)
        self.publisher = publisher
        self._inbox: Optional[Tuple[Dict, object]] = None   # guarded-by: self._inbox_lock
        self._inbox_lock = threading.Lock()
        if publisher is not None:
            self._subscription = publisher.subscribe(self._on_publish)
        self.server = server
        self.poll_s = float(poll_s)
        self.hub = hub
        # bounded per-version retry budget: a transient read failure
        # (NFS/GCS-fuse close-to-open lag can expose the manifest before
        # the blob settles) must not strand a worker on the old version
        # forever — but a genuinely corrupt artifact must not be
        # re-logged every poll either.  After max_retries the version is
        # parked until a strictly newer one appears.
        self.max_retries = int(max_retries)
        self.swaps = 0
        self._failed_version: Optional[int] = None
        self._failed_tries = 0
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "VersionWatcher":
        if self._thread is None:
            self._stop_event.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="gsc-serve-watcher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        if self.publisher is not None:
            self.publisher.unsubscribe(self._subscription)

    def _run(self):
        while not self._stop_event.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:   # a poll crash must not kill the thread
                log.exception("version watcher poll failed")

    def _on_publish(self, record: Dict, params):
        """In-process delivery (runs in the publisher's thread): store a
        reference, latest wins — adoption stays with poll_once in the
        consumer's own thread."""
        with self._inbox_lock:
            self._inbox = (record, params)

    def poll_once(self) -> bool:
        """One poll; returns True iff a swap happened."""
        if self.publisher is not None:
            with self._inbox_lock:
                item, self._inbox = self._inbox, None
            if item is None:
                return False
            rec, params = item
        else:
            rec = read_latest(self.root)
        if rec is None or rec["version"] <= self.server.policy_version:
            return False
        if rec["version"] == self._failed_version \
                and self._failed_tries >= self.max_retries:
            return False   # parked: retried enough, wait for a newer one
        try:
            if self.publisher is not None:
                leaves = host_leaves(params)
                # the in-process check standing in for the file path's
                # fingerprint: a version with a non-finite leaf is never
                # adopted (ValueError takes the retry bookkeeping below)
                if not leaves_finite(leaves):
                    raise ValueError(
                        f"non-finite leaf in in-process published version "
                        f"{rec['version']} — refusing to adopt")
            else:
                leaves = load_version(self.root, rec)
            self.server.apply_weights(leaves, rec["version"],
                                      rec["fingerprint"],
                                      meta=rec.get("meta"))
        except (ValueError, OSError) as e:
            if rec["version"] == self._failed_version:
                self._failed_tries += 1
            else:
                self._failed_version = rec["version"]
                self._failed_tries = 1
            log.warning(
                "hot-swap to version %s skipped (attempt %d/%d): %s",
                rec.get("version"), self._failed_tries,
                self.max_retries, e)
            if self.hub is not None:
                self.hub.counter("serve_swap_failed_total")
            return False
        self._failed_version = None
        self._failed_tries = 0
        self.swaps += 1
        return True


class FleetDispatcher:
    """Least-queue-depth routing over N workers + SLO-burn brownout.

    ``workers`` are started/closed by the dispatcher (so are the
    brownout tier and each worker's :class:`VersionWatcher` — the
    server owns its watcher).  ``spr`` is the optional brownout target:
    a fallback-tier :class:`PolicyServer` that absorbs overflow instead
    of the fleet rejecting it."""

    def __init__(self, workers: Sequence, spr=None, hub=None,
                 brownout_burn: Optional[float] = 2.0,
                 burn_refresh_s: float = 0.25, clock=time.monotonic):
        if not workers:
            raise ValueError("a fleet needs at least one worker")
        self.workers = list(workers)
        self.spr = spr
        self.hub = hub
        # error-budget burn rate above which (with a backlog on the least
        # loaded worker) new load sheds to the SPR tier; None disables
        # proactive shedding (overflow shedding on queue_full stays on)
        self.brownout_burn = brownout_burn
        self.burn_refresh_s = float(burn_refresh_s)
        # the refresh cadence's clock (a test injects its own)
        self.clock = clock
        self._burn_cache: Tuple[float, Optional[float]] = (float("-inf"), None)   # guarded-by: self._burn_lock
        self._burn_lock = threading.Lock()
        self._series_ts = float("-inf")   # last flight-recorder sample

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "FleetDispatcher":
        for w in self.workers:
            w.start()
        if self.spr is not None:
            self.spr.start()
        if self.hub is not None:
            self.hub.event(
                "fleet_start", workers=[w.worker for w in self.workers],
                tier=self.workers[0].tier,
                brownout=("spr" if self.spr is not None else None),
                brownout_burn=self.brownout_burn)
        return self

    def close(self):
        # one forced ring sample on the way out, so even a short load
        # leaves the fleet's final queue/occupancy picture in history
        self.sample_series(force=True)
        for w in self.workers:
            w.close()
        if self.spr is not None:
            self.spr.close()
        if self.hub is not None:
            # fleet-level final record AFTER the workers' final
            # serve_stats: the per-worker events carry worker-local
            # counts, this one carries the fleet totals obs_report's
            # fleet view leads with
            self.hub.event(
                "fleet_stats", final=True,
                workers=[w.worker for w in self.workers],
                requests=self.completed, swaps=self.swap_total(),
                brownout={reason: int(self.hub.get_counter(
                    "serve_brownout_total", reason=reason))
                    for reason in ("slo_burn", "overflow")},
                per_worker={w.worker: {
                    "requests": w._completed,
                    "policy_version": w.policy_version,
                    "swaps": w.swaps,
                    "occupancy": {str(b): n for b, n in
                                  sorted(w._occupancy.items())},
                } for w in self.workers},
                slo=self.slo_summary())

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ requests
    def submit(self, obs) -> ServeFuture:
        """Route one request: least queue depth wins; ties go to the
        first worker (stable under the idle fleet).  Sheds to the SPR
        tier on sustained budget burn (proactive) or a full worker queue
        (reactive) — the fleet only rejects when there is nowhere left
        to put the request."""
        self.sample_series()
        worker = min(self.workers, key=lambda w: w.queue_depth)
        if self.spr is not None and self._should_brownout(worker):
            self._count_brownout("slo_burn")
            return self.spr.submit(obs)
        try:
            return worker.submit(obs)
        except ServeError:
            if self.spr is None:
                raise
            self._count_brownout("overflow")
            return self.spr.submit(obs)

    def submit_sync(self, obs, timeout: Optional[float] = 60.0):
        return self.submit(obs).result(timeout)

    # ------------------------------------------------------------ brownout
    def _count_brownout(self, reason: str):
        if self.hub is not None:
            self.hub.counter("serve_brownout_total", reason=reason)

    def _should_brownout(self, worker) -> bool:
        if self.brownout_burn is None or worker.queue_depth < 1:
            return False
        burn = self._fleet_burn()
        return burn is not None and burn > self.brownout_burn

    def _fleet_burn(self) -> Optional[float]:
        """Max error-budget burn rate across the workers' SLO engines,
        refreshed at ``burn_refresh_s`` cadence (an engine snapshot walks
        its rolling window — too heavy per submit).  Each refresh also
        feeds the flight-recorder rings (:meth:`sample_series`) — the
        serving fleet's history rides the existing rate limit, never a
        per-submit cost."""
        now = self.clock()
        with self._burn_lock:
            ts, burn = self._burn_cache
            if now - ts < self.burn_refresh_s:
                return burn
            burns = []
            for w in self.workers:
                engine = getattr(w, "slo_engine", None)
                if engine is None:
                    continue
                snap = engine.snapshot()
                b = snap.get("burn_rate")
                if b is not None:
                    burns.append(b)
                self._series_from_snapshot(w, snap)
            burn = max(burns) if burns else None
            self._burn_cache = (now, burn)
            if burn is not None and self.hub is not None:
                self.hub.series("serve_burn_rate", burn)
            return burn

    def _series_from_snapshot(self, worker, snap: Dict):
        """One worker's ring points from an engine snapshot it already
        paid for: pad waste per bucket + overall (``series`` no-ops on a
        history-free hub, so this is free when the recorder is off)."""
        if self.hub is None:
            return
        pad = snap.get("pad_waste")
        if pad is not None:
            self.hub.series("serve_pad_waste", pad, worker=worker.worker)
        for bucket, rec in (snap.get("per_bucket") or {}).items():
            bpad = rec.get("pad_waste")
            if bpad is not None:
                self.hub.series("serve_pad_waste", bpad,
                                worker=worker.worker, bucket=bucket)

    def sample_series(self, force: bool = False):
        """Feed the flight-recorder rings one fleet sample: per-worker
        queue depth and per-bucket batch occupancy, plus the SLO-derived
        points (pad waste, burn) via :meth:`_fleet_burn`.  Called from
        :meth:`submit` but self-rate-limited to ``burn_refresh_s`` — the
        dispatch path only ever pays an attribute check and a clock
        read.  No-op without a hub or without a series window."""
        if self.hub is None \
                or getattr(self.hub, "series_store", None) is None:
            return
        now = self.clock()
        if not force and now - self._series_ts < self.burn_refresh_s:
            return
        self._series_ts = now
        for w in self.workers:
            self.hub.series("serve_queue_depth", w.queue_depth,
                            worker=w.worker)
            for bucket, n in sorted(w._occupancy.items()):
                self.hub.series("serve_occupancy", n, worker=w.worker,
                                bucket=bucket)
        self._fleet_burn()

    # --------------------------------------------------------------- stats
    @property
    def completed(self) -> int:
        total = sum(w._completed for w in self.workers)
        if self.spr is not None:
            total += self.spr._completed
        return total

    def swap_total(self) -> int:
        return sum(w.swaps for w in self.workers)

    def slo_summary(self) -> Optional[Dict]:
        doc = self.merged_slo()
        if doc is None:
            return None
        out = {k: doc.get(k) for k in
               ("requests", "deadline_misses", "deadline_miss_ratio",
                "attainment", "burn_rate", "pad_waste",
                "queue_wait_frac", "arrival_rate_rps", "rejected")}
        out["p99_target_ms"] = (doc.get("objectives") or {}).get("p99_ms")
        return out

    def merged_slo(self) -> Optional[Dict]:
        """One fleet-level SLO document from the workers' engines.

        Counts (requests, misses, flushes, rejections) sum exactly;
        window-derived ratios merge as weighted means (attainment by
        window size, pad waste by flushes, queue-wait fraction by
        requests) — a faithful approximation, since the per-worker sums
        behind them are not exposed.  Burn is recomputed from the merged
        attainment so the fleet number stays internally consistent."""
        snaps = [(w, w.slo_engine.snapshot()) for w in self.workers
                 if getattr(w, "slo_engine", None) is not None]
        if not snaps:
            return None
        first = snaps[0][1]
        requests = sum(s["requests"] for _, s in snaps)
        misses = sum(s["deadline_misses"] for _, s in snaps)
        errored = sum(s["errored_requests"] for _, s in snaps)
        flushes = sum(s["flushes"] for _, s in snaps)
        rejected: Dict[str, int] = {}
        for _, s in snaps:
            for reason, n in (s.get("rejected") or {}).items():
                rejected[reason] = rejected.get(reason, 0) + int(n)

        def wmean(key, weight_key):
            num = den = 0.0
            for _, s in snaps:
                v, w = s.get(key), s.get(weight_key)
                if key == "attainment":
                    w = (s.get("window") or {}).get("size")
                if v is None or not w:
                    continue
                num += v * w
                den += w
            return round(num / den, 6) if den else None

        attainment = wmean("attainment", "window")
        burn = None
        if attainment is not None:
            budget = 1.0 - first["objectives"]["target_attainment"]
            burn = round((1.0 - attainment) / budget, 4)
        rates = [s.get("arrival_rate_rps") for _, s in snaps
                 if s.get("arrival_rate_rps") is not None]
        return {
            "fleet_workers": [w.worker for w, _ in snaps],
            "deadline_ms": first["deadline_ms"],
            "objectives": first["objectives"],
            "requests": requests,
            "errored_requests": errored,
            "deadline_misses": misses,
            "deadline_miss_ratio": (round(misses / requests, 6)
                                    if requests else None),
            "attainment": attainment,
            "burn_rate": burn,
            "arrival_rate_rps": (round(sum(rates), 3) if rates else None),
            "flushes": flushes,
            "pad_waste": wmean("pad_waste", "flushes"),
            "queue_wait_frac": wmean("queue_wait_frac", "requests"),
            "rejected": rejected,
            "per_worker": {w.worker: {
                "requests": s["requests"],
                "deadline_miss_ratio": s["deadline_miss_ratio"],
                "attainment": s["attainment"],
                "pad_waste": s["pad_waste"],
            } for w, s in snaps},
        }
