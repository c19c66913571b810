"""Learning-curve extraction: events.jsonl -> schema-versioned
curves.json.

The port of ``gsc_tpu.obs.curves``, with the same schema version.  It
extracts the per-episode series a run's event stream carries
(``episode`` / ``harness_episode`` events for returns and losses,
``learn_signal`` events for |TD| and Q moments) into one ``curves.json``:

- ``series``: aligned per-episode lists (episode, episodic_return,
  critic_loss, actor_loss, sps, td_abs_mean, q_mean), non-finite values
  as null;
- ``per_topology``: per-network return and |TD| series;
- ``summary``: what ``tools/bench_diff.py`` gates under its bands,
  ``final_window_return`` (mean of the last W episodes), ``auc_return``,
  ``episodes_to_threshold`` (first episode whose trailing W-mean reaches
  ``first + 0.9 * (final - first)``; null when the curve never rose) and
  ``final_window_td_abs``.

``RunObserver.close()`` writes it next to metrics.json; a stream with
several runs is cut at ``run_start`` and the last run wins.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

CURVES_SCHEMA_VERSION = 1
# envelope window: the "mean reward over the last 10 episodes" the repo's
# select_best_agent discipline already uses
FINAL_WINDOW = 10
THRESHOLD_FRACTION = 0.9


def _finite(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def _mean(vals: List[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    return round(sum(vals) / len(vals), 6) if vals else None


def _last_run(events: List[Dict]) -> List[Dict]:
    starts = [i for i, e in enumerate(events)
              if isinstance(e, dict) and e.get("event") == "run_start"]
    return events[starts[-1]:] if starts else events


def extract_curves(events: List[Dict], window: int = FINAL_WINDOW,
                   threshold_fraction: float = THRESHOLD_FRACTION) -> Dict:
    """Build the curves document from a (ts-sorted) event stream."""
    events = _last_run([e for e in events if isinstance(e, dict)])
    run = next((e.get("run") for e in events if e.get("run")), None)

    # per-episode rows keyed by episode index; 'episode' events are the
    # trainer's drained rows (both paths); harness_episode fills gaps for
    # harness-only drivers (tools/learning_curve.py)
    rows: Dict[int, Dict] = {}
    for ev in events:
        kind = ev.get("event")
        ep = ev.get("episode")
        if not isinstance(ep, int):
            continue
        if kind == "episode":
            row = rows.setdefault(ep, {})
            for src, dst in (("episodic_return", "episodic_return"),
                             ("critic_loss", "critic_loss"),
                             ("actor_loss", "actor_loss"), ("sps", "sps")):
                if src in ev:
                    row[dst] = _finite(ev.get(src))
            if ev.get("topology"):
                row["topology"] = str(ev["topology"])
        elif kind == "harness_episode":
            row = rows.setdefault(ep, {})
            row.setdefault("episodic_return",
                           _finite(ev.get("episodic_return")))
            for name, v in (ev.get("per_topology_return") or {}).items():
                row.setdefault("per_topology_return", {})[str(name)] = \
                    _finite(v)
        elif kind == "learn_signal":
            row = rows.setdefault(ep, {})
            row["td_abs_mean"] = _finite(ev.get("td_abs_mean"))
            row["q_mean"] = _finite(ev.get("q_mean"))
            for name, v in (ev.get("per_topology_td") or {}).items():
                row.setdefault("per_topology_td", {})[str(name)] = \
                    _finite(v)

    episodes = sorted(rows)
    series = {"episode": episodes}
    for key in ("episodic_return", "critic_loss", "actor_loss", "sps",
                "td_abs_mean", "q_mean"):
        col = [rows[ep].get(key) for ep in episodes]
        if any(v is not None for v in col):
            series[key] = col

    per_topology: Dict[str, Dict[str, list]] = {}

    def topo_row(name: str) -> Dict[str, list]:
        return per_topology.setdefault(
            name, {"episode": [], "return": [], "td_abs_mean": []})

    for ep in episodes:
        row = rows[ep]
        names = set(row.get("per_topology_return") or {}) \
            | set(row.get("per_topology_td") or {})
        if row.get("topology"):
            names.add(row["topology"])
        for name in names:
            t = topo_row(name)
            t["episode"].append(ep)
            ret = (row.get("per_topology_return") or {}).get(name)
            if ret is None and row.get("topology") == name:
                ret = row.get("episodic_return")
            t["return"].append(ret)
            t["td_abs_mean"].append(
                (row.get("per_topology_td") or {}).get(name))

    returns = [rows[ep].get("episodic_return") for ep in episodes]
    tds = [rows[ep].get("td_abs_mean") for ep in episodes]
    w = max(min(window, len(episodes)), 1)
    summary: Dict = {"window": window,
                     "threshold_fraction": threshold_fraction}
    finite_returns = [r for r in returns if r is not None]
    if finite_returns:
        first_w = _mean(returns[:w])
        final_w = _mean(returns[-w:])
        summary["first_window_return"] = first_w
        summary["final_window_return"] = final_w
        summary["auc_return"] = _mean(returns)
        # episodes-to-threshold: first episode whose TRAILING w-mean
        # reaches 90% of the first->final rise; null when the curve
        # never rose (a flat/declining run has no "time to learn")
        ett = None
        if first_w is not None and final_w is not None \
                and final_w > first_w:
            threshold = first_w + threshold_fraction * (final_w - first_w)
            summary["threshold_return"] = round(threshold, 6)
            for i in range(len(episodes)):
                trail = _mean(returns[max(0, i - w + 1):i + 1])
                if trail is not None and trail >= threshold:
                    ett = episodes[i]
                    break
        summary["episodes_to_threshold"] = ett
    if any(t is not None for t in tds):
        summary["final_window_td_abs"] = _mean(tds[-w:])

    return {
        "schema_version": CURVES_SCHEMA_VERSION,
        "run": run,
        "episodes": len(episodes),
        "series": series,
        "per_topology": per_topology,
        "summary": summary,
    }


def write_curves(path: str, events: List[Dict],
                 window: int = FINAL_WINDOW) -> str:
    """Atomic curves.json write (same contract as metrics.json)."""
    from .sinks import write_atomic_json

    return write_atomic_json(path, extract_curves(events, window=window))
