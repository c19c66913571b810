"""The port's linter, run from the command line.

Usage::

    python -m gsc_tpu_torch.analysis.lint [paths...]  # default: gsc_tpu_torch/ chip_smoke.py
    python -m gsc_tpu_torch.analysis.lint --json [paths...]
    python -m gsc_tpu_torch.analysis.lint --rules R1,R4 [paths...]
    python -m gsc_tpu_torch.analysis.lint --changed [REF]   # files in git diff REF
    python -m gsc_tpu_torch.analysis.lint --write-baseline  # accept current findings
    python -m gsc_tpu_torch.analysis.lint --prune-stale     # drop entries that match nothing
    python -m gsc_tpu_torch.analysis.lint --no-baseline     # raw findings

Rules (``astlint.py``, ``concur.py``; R2 and R5 are dropped, see
``findings.DROPPED_RULES``):
    R1  host syncs (.item(), .cpu(), .numpy(), .tolist(), float()/int()/
        bool() or `if` on a tensor, torch.cuda/Event/Stream synchronize)
        reachable from a step entry point (astlint.STEP_ROOTS)
    R3  global RNG (no generator=, manual_seed, np.random.<fn>,
        random.<fn>) or wall-clock reads reachable from a step entry point
    R4  products in bf16-policy modules (ops/, models/) whose operands are
        not widened to f32 outside an f32-gated branch
    R6  lock-order cycle: two functions nest the same locks in opposite
        orders
    R7  field annotated ``# guarded-by: <lock>`` read/written without
        holding that lock (``# requires-lock:`` on a def asserts callers
        hold it)
    R8  multi-rank dispatch (chunk_step / rollout_episodes / learn_burst /
        replay_ingest) in a thread-spawning module outside
        ``with dispatch_lock:``
    R9  blocking call (untimed get/wait/join/result, nested acquire,
        device call) while holding a lock
    R10 threading.Thread(...) without name=/daemon=

Exit status: 0 when every finding is suppressed (baseline entry or an
inline ``gsc-lint: disable=R<k> -- <reason>`` marker), 1 when new
findings exist, 2 on a usage error.  The baseline is
``gsc_tpu_torch/analysis/lint_baseline.json``, one written reason per
entry.  ``--write-baseline`` rewrites it from the current findings,
keeping existing reasons; entries it has to stamp with a TODO reason make
it exit 1 until a person replaces them.  Stale entries (matching nothing
in the linted scope) are reported, never fatal.  The flags and exit codes
are ``tools/gsc_lint.py``'s.  The linter's modules are stdlib only; ``-m``
imports the package (and torch with it) but touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from .astlint import _iter_py_files, lint_files
from .baseline import (build_result, inline_suppression, load_baseline,
                       save_baseline)
from .findings import DROPPED_RULES, RULE_IDS, RULE_TITLES

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATHS = ("gsc_tpu_torch/", "chip_smoke.py")
DEFAULT_BASELINE = os.path.join(REPO_ROOT, "gsc_tpu_torch", "analysis",
                                "lint_baseline.json")


def _rel(path: str, root: str) -> str:
    return os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")


def _git_changed_files(ref: str, root: str) -> Optional[List[str]]:
    """Repo-relative paths changed against ``ref`` (staged and unstaged),
    or None when git is unavailable or this is no work tree: the caller
    then scans everything rather than linting nothing."""
    try:
        proc = subprocess.run(["git", "diff", "--name-only", ref], cwd=root,
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return [ln.strip().replace(os.sep, "/")
            for ln in proc.stdout.splitlines() if ln.strip()]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gsc_tpu_torch.analysis.lint",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="\n".join([f"  {r}  {RULE_TITLES[r]}" for r in RULE_IDS]
                         + [f"  {r}  dropped: {why}"
                            for r, why in sorted(DROPPED_RULES.items())]))
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint [default: {DEFAULT_PATHS}]")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression baseline JSON [default: "
                         "gsc_tpu_torch/analysis/lint_baseline.json]")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report every finding)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(existing reasons kept; new entries get a TODO "
                         "reason)")
    ap.add_argument("--prune-stale", action="store_true",
                    help="rewrite the baseline without its stale entries "
                         "(matching nothing in the linted scope)")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="lint only .py files in `git diff --name-only "
                         "REF` [REF default: HEAD]; scans everything when "
                         "git is unavailable")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. R1,R4")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary lines")
    return ap


def main(argv: Optional[List[str]] = None,
         root: Optional[str] = None) -> int:
    """Run the linter; ``root`` anchors relative paths and ``git`` (default:
    the repository holding this package)."""
    root = os.path.abspath(root or REPO_ROOT)
    ap = _parser()
    args = ap.parse_args(argv)

    rules = None
    if args.rules:
        rules = {r.strip().upper() for r in args.rules.split(",")}
        dropped = rules & set(DROPPED_RULES)
        if dropped:
            ap.error("; ".join(f"{r} is dropped in the port: "
                               f"{DROPPED_RULES[r]}" for r in sorted(dropped)))
        bad = rules - set(RULE_IDS)
        if bad:
            ap.error(f"unknown rule(s): {sorted(bad)}")

    paths = args.paths or [os.path.join(root, p) for p in DEFAULT_PATHS]
    for p in paths:
        if not os.path.exists(p):
            ap.error(f"no such path: {p}")
        if os.path.isfile(p) and not p.endswith(".py"):
            # _iter_py_files would drop it and report a clean "0 files"
            # run: an explicit unlintable file is a usage error
            ap.error(f"not a Python file: {p}")
    if args.prune_stale and args.no_baseline:
        ap.error("--prune-stale needs the baseline (drop --no-baseline)")

    files = _iter_py_files(paths)
    if args.write_baseline:
        raw, _ = lint_files(files, rules=rules, root=root)
        # inline-marked findings are suppressed at their line; an entry for
        # one would match nothing on the next run and report as stale
        raw = [f for f in raw
               if not inline_suppression(f.line_text, f.rule)]
        existing = (load_baseline(args.baseline)
                    if os.path.exists(args.baseline) else [])
        # a scoped rewrite (a --rules or path subset) keeps every entry
        # outside its scope verbatim
        linted = {_rel(f, root) for f in files}
        preserved = [e for e in existing
                     if (rules is not None and e.get("rule") not in rules)
                     or e.get("path") not in linted]
        n = save_baseline(args.baseline, raw, existing=existing,
                          preserve=preserved)
        print(f"gsc-lint: baseline rewritten with {n} suppression(s) -> "
              f"{args.baseline}")
        todo = sum(1 for e in load_baseline(args.baseline)
                   if e["reason"].startswith("TODO"))
        if todo:
            print(f"gsc-lint: {todo} entries need a written reason "
                  "(search for TODO) before the baseline is reviewable")
            return 1
        return 0

    if args.changed is not None:
        changed = _git_changed_files(args.changed, root)
        if changed is None:
            if not args.quiet:
                print("gsc-lint: --changed: git unavailable, falling "
                      "back to a full scan", file=sys.stderr)
        else:
            changed_set = set(changed)
            files = [f for f in files if _rel(f, root) in changed_set]
            if not files:
                if args.as_json:
                    json.dump({"files": 0, "findings": [],
                               "suppressed": [], "stale_suppressions": [],
                               "by_rule": {}, "ok": True},
                              sys.stdout, indent=1)
                    sys.stdout.write("\n")
                elif not args.quiet:
                    print("gsc-lint: no lintable files changed vs "
                          f"{args.changed}")
                return 0

    all_entries = [] if args.no_baseline else load_baseline(args.baseline)
    entries = all_entries
    if rules:
        entries = [e for e in entries
                   if e.get("rule") in rules or not e.get("rule")]
    raw, nfiles = lint_files(files, rules=rules, root=root)
    result = build_result(raw, entries, nfiles)

    # an entry is stale only if this run re-checked its file: a scoped run
    # must not report (or prune) suppressions it never looked at
    linted = {_rel(f, root) for f in files}
    stale = [e for e in result.stale_suppressions
             if e.get("path") in linted]

    if args.prune_stale:
        prune = {e["fingerprint"] for e in stale}
        if prune:
            keep = [e for e in all_entries if e["fingerprint"] not in prune]
            save_baseline(args.baseline, [], preserve=keep)
        print(f"gsc-lint: pruned {len(prune)} stale suppression(s) -> "
              f"{args.baseline}")
        stale = []

    if args.as_json:
        json.dump({
            "files": result.files,
            "findings": [f.to_json() for f in result.findings],
            "suppressed": [f.to_json() for f in result.suppressed],
            "stale_suppressions": stale,
            "by_rule": result.by_rule(),
            "ok": result.ok,
        }, sys.stdout, indent=1)
        sys.stdout.write("\n")
        return 0 if result.ok else 1

    for f in result.findings:
        print(f.format())
    if not args.quiet:
        by_rule = result.by_rule()
        detail = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
        print(f"gsc-lint: {result.files} files, "
              f"{len(result.findings)} finding(s)"
              + (f" ({detail})" if detail else "")
              + f", {len(result.suppressed)} suppressed"
              + (f", {len(stale)} stale" if stale else ""))
        for e in stale:
            print(f"gsc-lint: stale suppression (matched nothing): "
                  f"{e['fingerprint']} {e.get('path', '?')}: run "
                  "--prune-stale to drop it")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
