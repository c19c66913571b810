"""Deterministic fault injection: the ``FaultPlan`` grammar and firing.

The port of ``gsc_tpu.resilience.faults``; the grammar parses exactly as
the JAX package parses it.  A plan injects named faults at named sites
keyed by episode, so every self-healing path of the trainer has a test
that runs it.  The single-env and replica trainers fire these sites:

==================== =====================================================
site                 effect when the keyed episode is reached
==================== =====================================================
``prefetch_die``     the prefetcher's producer thread raises while
                     staging the keyed episode (surfaced on the
                     consumer's next ``get``; the trainer restarts it)
``slow_episode``     the producer sleeps ``arg`` seconds (default 1.0)
                     before staging the keyed episode (long enough to
                     trip the watchdog, whose escalation restarts it)
``dispatch_transient`` the episode's dispatch raises a
                     ``TransientDispatchError`` once; the retry layer
                     backs off and dispatches again
``nan_grads``        the learner state entering the keyed episode is
                     poisoned with NaN; the on-device all-finite flag
                     catches it at the drain and the trainer rolls back
``ckpt_corrupt``     the first periodic checkpoint written at or after
                     the keyed episode is damaged on disk; checksum
                     validation catches it and the manager saves again
``publish_corrupt``  (keyed by version, ``--hot-swap-dir``) the
                     ``WeightPublisher`` writes that version's blob with
                     one byte flipped under a clean manifest; the serving
                     watchers' fingerprint check refuses it
==================== =====================================================

The decoupled actor/learner fleet (``train --async``,
``parallel.async_rl``) fires four more, as the JAX package does:

==================== =====================================================
``actor_die``        (``actor_die@a0:3``) actor 0 raises at entry to
                     episode 3; the supervisor restarts it from its
                     episode counter, degrading the fleet past the
                     restart budget
``ring_poison``      the keyed episode's produced blocks are NaN copies;
                     the learner quarantines them instead of ingesting
``watcher_stall``    (``watcher_stall@a1:4[:seconds]``) the actor's
                     version poll raises; it skips that adoption
``learner_transient`` learn-burst dispatch raises the retryable transient
                     class at entry to the keyed burst index; the retry
                     layer backs off and dispatches again
==================== =====================================================

A plan naming one of them outside ``--async`` could never fire:
:func:`refuse_async_sites` stops it before the serial loops start
(the JAX CLI lets it pass and warns at the end that it never fired).

Grammar (``--fault-plan`` / env ``GSC_FAULT_PLAN``)::

    plan  := entry (";" entry)*
    entry := site "@" key [":" arg]
    key   := episode                  (episode/burst-keyed sites)
           | "a" actor ":" episode   (actor-keyed: actor_die, watcher_stall)
           | "v" version             (version-keyed: publish_corrupt)

e.g. ``prefetch_die@1;nan_grads@3;slow_episode@2:1.5``.  Each entry fires
exactly once (thread-safe), so a restarted prefetcher re-staging the
same episode does not hit the fault again.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import List, Optional

log = logging.getLogger("gsc_tpu_torch.resilience.faults")

SITES = ("prefetch_die", "slow_episode", "dispatch_transient", "nan_grads",
         "ckpt_corrupt", "actor_die", "ring_poison", "publish_corrupt",
         "watcher_stall", "learner_transient")

# per-site key domains: actor-keyed sites REQUIRE the a<actor>:<episode>
# form, version-keyed the v<version> form; everything else is a plain
# int (an episode index, or a learn-burst index for learner_transient)
ACTOR_KEYED = ("actor_die", "watcher_stall")
VERSION_KEYED = ("publish_corrupt",)
BURST_KEYED = ("learner_transient",)

ENV_VAR = "GSC_FAULT_PLAN"

# the sites only the decoupled actor/learner fleet fires
ASYNC_SITES = ("actor_die", "ring_poison", "watcher_stall",
               "learner_transient")


class FaultInjected(RuntimeError):
    """An injected (non-transient) fault — e.g. the prefetcher producer's
    death.  Distinct from the transient class so the retry layer never
    retries a fault that models a hard failure."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    episode: int                     # episode / burst / version key
    arg: Optional[float] = None
    actor: Optional[int] = None      # actor-keyed sites only
    fired_at: Optional[int] = None   # key the fault actually fired at

    @property
    def fired(self) -> bool:
        return self.fired_at is not None

    @property
    def key(self) -> str:
        """The entry's key in grammar form (``3``, ``a0:3``, ``v2``)."""
        if self.actor is not None:
            return f"a{self.actor}:{self.episode}"
        if self.site in VERSION_KEYED:
            return f"v{self.episode}"
        return str(self.episode)


class FaultPlan:
    """Parsed fault schedule; ``fire`` is the single (locked) gate every
    injection site calls — marking the spec fired so each entry triggers
    exactly once even across prefetcher restarts and dispatch retries."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for raw in text.replace(",", ";").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "@" not in raw:
                raise ValueError(
                    f"fault-plan entry {raw!r} is not 'site@episode[:arg]'")
            site, _, rest = raw.partition("@")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (expected one of "
                    f"{', '.join(SITES)})")
            actor = None
            if site in ACTOR_KEYED:
                # a<actor>:<episode>[:arg] — the actor prefix is REQUIRED:
                # an actor-keyed fault with no actor would fire on whoever
                # reaches the episode first, making chaos runs racy
                if not rest.startswith("a"):
                    raise ValueError(
                        f"fault-plan entry {raw!r}: {site} is actor-keyed "
                        f"— use {site}@a<actor>:<episode>")
                actor_s, _, rest = rest[1:].partition(":")
                try:
                    actor = int(actor_s)
                except ValueError:
                    raise ValueError(
                        f"fault-plan entry {raw!r}: actor {actor_s!r} is "
                        "not an integer")
                if actor < 0:
                    raise ValueError(
                        f"fault-plan entry {raw!r}: actor must be >= 0")
                if not rest:
                    raise ValueError(
                        f"fault-plan entry {raw!r}: missing episode — use "
                        f"{site}@a<actor>:<episode>")
            elif site in VERSION_KEYED:
                if not rest.startswith("v"):
                    raise ValueError(
                        f"fault-plan entry {raw!r}: {site} is version-"
                        f"keyed — use {site}@v<version>")
                rest = rest[1:]
            ep_s, _, arg_s = rest.partition(":")
            try:
                episode = int(ep_s)
            except ValueError:
                what = ("version" if site in VERSION_KEYED else
                        "burst" if site in BURST_KEYED else "episode")
                raise ValueError(
                    f"fault-plan entry {raw!r}: {what} {ep_s!r} is not an "
                    "integer")
            if episode < 0:
                raise ValueError(
                    f"fault-plan entry {raw!r}: episode must be >= 0")
            arg = None
            if arg_s:
                try:
                    arg = float(arg_s)
                except ValueError:
                    raise ValueError(
                        f"fault-plan entry {raw!r}: arg {arg_s!r} is not a "
                        "number")
            specs.append(FaultSpec(site=site, episode=episode, arg=arg,
                                   actor=actor))
        if not specs:
            raise ValueError(f"empty fault plan {text!r}")
        return cls(specs)

    @classmethod
    def from_env(cls, flag: Optional[str] = None) -> Optional["FaultPlan"]:
        """Plan from an explicit flag value, falling back to the
        ``GSC_FAULT_PLAN`` environment variable only when no flag was
        given at all; None when neither is set.  An EXPLICIT empty flag
        (``--fault-plan ''``) disables injection even under an exported
        env plan — that is how an operator runs the clean control leg of
        a chaos comparison."""
        if flag is not None:
            text = flag.strip()
        else:
            text = os.environ.get(ENV_VAR, "").strip()
        return cls.parse(text) if text else None

    def fire(self, site: str, episode: int, actor: Optional[int] = None,
             at_or_after: bool = False) -> Optional[FaultSpec]:
        """The unfired spec for ``site`` keyed at ``episode`` (exact match,
        or the oldest spec with ``spec.episode <= episode`` when
        ``at_or_after`` — checkpoint saves only happen every interval, so
        an exact key could never land).  Actor-keyed specs additionally
        require ``actor`` to match, so ``actor_die@a0:3`` never fires on
        actor 1 even if it reaches episode 3 first.  Marks the spec
        fired."""
        with self._lock:
            for spec in self.specs:
                if spec.site != site or spec.fired:
                    continue
                if spec.actor is not None and spec.actor != actor:
                    continue
                if spec.episode == episode or (at_or_after
                                               and spec.episode <= episode):
                    spec.fired_at = episode
                    log.warning("fault injected: %s@%s (fired at key "
                                "%d, arg=%s)", site, spec.key, episode,
                                spec.arg)
                    return spec
        return None

    def summary(self) -> List[dict]:
        """JSON-able plan description (run_start meta / reports)."""
        with self._lock:
            return [{"site": s.site, "episode": s.episode, "arg": s.arg,
                     "actor": s.actor, "key": s.key, "fired": s.fired}
                    for s in self.specs]

    def unfired(self) -> List[FaultSpec]:
        """Specs that never triggered — a mis-keyed plan (e.g. an episode
        index past the run's end) should be loud, not silently green."""
        with self._lock:
            return [s for s in self.specs if not s.fired]

    def warn_unfired(self, hub=None) -> List[FaultSpec]:
        """End-of-run check shared by every training path (serial,
        replica-parallel, async): any entry that never fired gets a
        log.warning AND a structured ``fault_plan_unfired`` event on the
        hub, so a mis-keyed chaos plan cannot make a run look exercised
        while proving nothing.  Returns the unfired specs."""
        un = self.unfired()
        if un:
            keys = [f"{s.site}@{s.key}" for s in un]
            log.warning("fault plan entries never fired: %s", keys)
            if hub is not None:
                hub.event("fault_plan_unfired", entries=keys,
                          count=len(keys))
        return un


def refuse_async_sites(plan: Optional[FaultPlan]) -> None:
    """Raise ValueError when ``plan`` names a site that only the
    decoupled actor/learner fleet (``--async``) fires, before a serial
    loop that could never fire it."""
    if plan is None:
        return
    bad = [f"{s.site}@{s.key}" for s in plan.specs if s.site in ASYNC_SITES]
    if bad:
        raise ValueError(
            f"fault plan entries {bad} need the decoupled actor/learner "
            "fleet (--async); the serial sites are prefetch_die, "
            "slow_episode, dispatch_transient, nan_grads, ckpt_corrupt and "
            "publish_corrupt")
