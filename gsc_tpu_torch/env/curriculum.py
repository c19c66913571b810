"""TD-weighted auto-curriculum over scenario-factory families.

The port of ``gsc_tpu.env.curriculum`` (numpy on the host).  The learn
ledger (``obs.learning``) sums |TD-error| per ``topo_idx`` inside every
learn burst, and under a factory mix that index is the family.  After
each episode's drain:

- :class:`Curriculum` keeps one |TD| EWMA per family, updated from the
  episode's segment sums (``fold_td``);
- :meth:`Curriculum.weights` turns the EWMAs into sampling weights,
  ``(1 - floor) * softmax(ewma / temperature) + floor / K``, so batches
  follow the families that still carry learning signal while no family's
  weight falls below ``floor / K``;
- the [K] vector is the next episode's ``ScenarioFactory.sample_batch``
  family distribution.

Cold start: a family not observed yet borrows the largest observed EWMA;
with no observation at all the weights are uniform.  Knobs (``cli train
--curriculum-temperature/--curriculum-floor``): ``temperature`` flattens
(high) or sharpens (low) the skew; ``floor`` is the probability mass
always spread uniformly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class CurriculumConfig:
    """Host-side curriculum knobs (all pure-python; the device only ever
    sees the resulting probability vector)."""

    temperature: float = 1.0   # softmax temperature over the |TD| EWMAs
    floor: float = 0.25        # total uniform probability mass (0..1)
    alpha: float = 0.3         # EWMA step toward an episode's |TD| mean

    def __post_init__(self):
        if not 0.0 <= self.floor <= 1.0:
            raise ValueError(f"curriculum floor must be in [0, 1]: "
                             f"{self.floor}")
        if self.temperature <= 0.0:
            raise ValueError(f"curriculum temperature must be > 0: "
                             f"{self.temperature}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"curriculum alpha must be in (0, 1]: "
                             f"{self.alpha}")


class Curriculum:
    """Per-family |TD| EWMAs -> sampling weights (math in the module
    docstring).  Pure numpy on purpose: the update runs at drain cadence
    on already-synced values, and hand-computed unit tests can pin the
    arithmetic exactly."""

    def __init__(self, names: Sequence[str],
                 cfg: Optional[CurriculumConfig] = None):
        if not names:
            raise ValueError("curriculum needs at least one family name")
        self.names: List[str] = [str(n) for n in names]
        self.cfg = cfg or CurriculumConfig()
        k = len(self.names)
        self.ewma = np.zeros(k, np.float64)
        self.seen = np.zeros(k, bool)
        self.updates = 0

    @property
    def num_families(self) -> int:
        return len(self.names)

    def fold_td(self, td_abs_sum, td_count) -> np.ndarray:
        """Fold one drained episode's per-family |TD| segment sums into
        the EWMAs.  Families with zero transitions this episode keep
        their EWMA (no observation != zero TD); a family's FIRST
        observation initializes its EWMA to the observed mean instead of
        stepping from 0 (cold-start bias toward under-sampling).
        Non-finite segments are DROPPED like unobserved ones: the
        replica path deliberately continues past a poisoned learner
        state (no rollback guard — checkpoints/publishes skip, the loop
        runs on), and one NaN burst folded here would make EVERY
        family's weight NaN forever, silently killing the curriculum
        for the run's remainder.  Returns the updated EWMA vector (a
        copy)."""
        sums = np.asarray(td_abs_sum, np.float64).reshape(-1)
        counts = np.asarray(td_count, np.float64).reshape(-1)
        if sums.shape[0] != self.num_families \
                or counts.shape[0] != self.num_families:
            raise ValueError(
                f"TD segments have {sums.shape[0]} families, curriculum "
                f"tracks {self.num_families} ({self.names})")
        observed = (counts > 0) & np.isfinite(sums) & np.isfinite(counts)
        means = np.where(observed, sums / np.maximum(counts, 1.0), 0.0)
        a = self.cfg.alpha
        stepped = (1.0 - a) * self.ewma + a * means
        self.ewma = np.where(
            observed, np.where(self.seen, stepped, means), self.ewma)
        self.seen |= observed
        self.updates += 1
        return self.ewma.copy()

    def weights(self) -> np.ndarray:
        """The ``[K]`` family-sampling distribution for the NEXT episode:
        ``(1 - floor) * softmax(ewma / temperature) + floor / K``.
        Unseen families borrow the max seen EWMA (optimism); all-unseen
        is exactly uniform.  Always sums to 1 with every entry >=
        ``floor / K > 0`` (for ``floor > 0``)."""
        k = self.num_families
        if not self.seen.any():
            return np.full(k, 1.0 / k)
        logits = np.where(self.seen, self.ewma, self.ewma[self.seen].max())
        z = logits / self.cfg.temperature
        z = z - z.max()
        p = np.exp(z)
        p = p / p.sum()
        floor = self.cfg.floor
        return (1.0 - floor) * p + floor / k

    # ------------------------------------------------------------- emit
    def emit_weights(self, hub, episode: int) -> Optional[Dict]:
        """``curriculum_weight{family=...}`` gauges + one ``curriculum``
        event per drained episode (same hub pathway as the learn
        ledger's gauges; no-op without a hub)."""
        if hub is None:
            return None
        w = self.weights()
        for name, v in zip(self.names, w):
            hub.gauge("curriculum_weight", round(float(v), 6), family=name)
        return hub.event(
            "curriculum", episode=episode,
            weights={n: round(float(v), 6)
                     for n, v in zip(self.names, w)},
            td_ewma={n: round(float(e), 6)
                     for n, e in zip(self.names, self.ewma)},
            updates=self.updates)
