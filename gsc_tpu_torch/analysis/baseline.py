"""The suppression baseline of the port's linter.

The linter over-approximates (call resolution by name and annotation, no
dataflow), so accepted cases live in a JSON baseline
(``gsc_tpu_torch/analysis/lint_baseline.json``) that the runner treats as
the zero line: only NEW unsuppressed findings fail it.  Every entry
carries a one-line ``reason``; an entry that ``save_baseline`` has to
stamp with a TODO reason makes the runner's ``--write-baseline`` exit 1
until a person writes one.  Matching is by the line-number-independent
fingerprint (``findings.fingerprint``), so code motion never invalidates
an entry.

Inline marker: a source line carrying ``gsc-lint: disable=R<k> --
<reason>`` (or ``disable=ALL -- <reason>``) suppresses that rule's
findings on that line without a baseline entry, for cases whose reason
is best kept beside the code.  A marker without its ``-- <reason>``
suppresses nothing.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

from .findings import Finding, LintResult

BASELINE_VERSION = 1
_INLINE_RE = re.compile(
    r"gsc-lint:\s*disable=([A-Za-z0-9,]+)\s+--\s*\S")


def inline_suppression(line_text: str, rule: str) -> bool:
    """True when ``line_text`` carries an inline disable for ``rule``,
    with its reason."""
    m = _INLINE_RE.search(line_text)
    if not m:
        return False
    rules = {r.strip().upper() for r in m.group(1).split(",")}
    return "ALL" in rules or rule.upper() in rules


def load_baseline(path: Optional[str]) -> List[Dict]:
    """Baseline entries (empty when no file).  A present but corrupt
    baseline raises: linting against nothing would let new findings
    through while the runner reports clean."""
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {doc.get('version')!r} in "
            f"{path} (expected {BASELINE_VERSION})")
    entries = doc.get("suppressions", [])
    for e in entries:
        if not e.get("fingerprint"):
            raise ValueError(f"baseline entry missing fingerprint: {e}")
        if not e.get("reason"):
            raise ValueError(
                f"baseline entry {e.get('fingerprint')} has no reason — "
                "every suppression must say why it is accepted")
    return entries


def save_baseline(path: str, findings: List[Finding],
                  existing: Optional[List[Dict]] = None,
                  preserve: Optional[List[Dict]] = None) -> int:
    """Write a baseline covering ``findings``; existing entries keep their
    written reasons, new ones get a TODO reason to be filled in.
    ``preserve`` carries entries OUTSIDE the current run's scope (a
    ``--rules`` subset or a path subset) verbatim: a partial rewrite must
    not delete suppressions it never re-checked.  Returns the number of
    entries written."""
    by_fp = {e["fingerprint"]: e for e in (existing or [])}
    entries = []
    written = set()
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        if f.fingerprint in written:
            # identical flagged lines in one function share a fingerprint:
            # one entry suppresses (and one reason covers) all of them
            continue
        written.add(f.fingerprint)
        prev = by_fp.get(f.fingerprint)
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "line_text": f.line_text,
            "reason": (prev or {}).get(
                "reason", "TODO: justify or fix this finding"),
        })
    seen = {e["fingerprint"] for e in entries}
    for e in sorted(preserve or [],
                    key=lambda e: (e.get("path", ""), e["fingerprint"])):
        if e["fingerprint"] not in seen:
            seen.add(e["fingerprint"])
            entries.append(e)
    doc = {"version": BASELINE_VERSION, "suppressions": entries}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, path)
    return len(entries)


def apply_baseline(findings: List[Finding],
                   entries: List[Dict]) -> Tuple[List[Finding],
                                                 List[Finding],
                                                 List[Dict]]:
    """Partition raw findings into (unsuppressed, suppressed, stale
    baseline entries).  Inline ``gsc-lint: disable`` markers are honoured
    first, then fingerprint matches."""
    by_fp = {e["fingerprint"]: e for e in entries}
    matched = set()
    live: List[Finding] = []
    quiet: List[Finding] = []
    for f in findings:
        if inline_suppression(f.line_text, f.rule):
            f.suppressed_by = "inline"
            quiet.append(f)
            continue
        entry = by_fp.get(f.fingerprint)
        if entry is not None:
            f.suppressed_by = entry["reason"]
            matched.add(f.fingerprint)
            quiet.append(f)
        else:
            live.append(f)
    stale = [e for fp, e in by_fp.items() if fp not in matched]
    return live, quiet, stale


def build_result(findings: List[Finding], entries: List[Dict],
                 files: int) -> LintResult:
    live, quiet, stale = apply_baseline(findings, entries)
    return LintResult(findings=live, suppressed=quiet, files=files,
                      stale_suppressions=stale)
