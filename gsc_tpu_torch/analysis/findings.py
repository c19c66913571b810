"""Finding records and stable fingerprints of the port's linter.

A finding pins a rule violation to (file, function, source line).  The
fingerprint leaves the line number out: code that moves up or down must
not invalidate the suppression baseline, so its identity is the hash of
(rule, relative path, enclosing qualname, the offending line's source
with its whitespace removed).  Two identical lines in one function share
a fingerprint: suppressing one suppresses both, which is the conservative
direction for a baseline.  The hash is the JAX package's
(``gsc_tpu.analysis.findings.fingerprint``): one input gives one
fingerprint in both packages, so their baselines mean the same thing.

Rules R2 (use after donation) and R5 (weak-typed scalars at a jitted
entry point) have no meaning in eager PyTorch and are dropped
(``DROPPED_RULES`` says why); their ids stay reserved.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# rule ids are stable API: the baseline file, the README table and the
# tests reference them
RULE_IDS = ("R1", "R3", "R4", "R6", "R7", "R8", "R9", "R10")

RULE_TITLES = {
    "R1": "host sync (.item(), .cpu(), .numpy(), .tolist(), float()/int()/"
          "bool() or `if` on a tensor, a synchronize) reachable from a "
          "step entry point",
    "R3": "global RNG (no generator=) or a wall-clock read reachable from "
          "a step entry point",
    "R4": "matmul/einsum/F.linear/bmm in a bf16-policy module whose "
          "operands are not widened to f32 outside an f32-gated branch",
    "R6": "lock-order cycle (same locks nested in opposite orders)",
    "R7": "guarded-by field touched outside a `with` on its lock",
    "R8": "multi-rank dispatch in a thread-spawning module outside "
          "dispatch_lock",
    "R9": "blocking call (untimed get/wait/join/result, nested "
          "acquire, device call) while holding a lock",
    "R10": "threading.Thread without name=/daemon= (unnamed threads "
           "break watchdog/blackbox post-mortems)",
}

DROPPED_RULES = {
    "R2": "use after donation: eager PyTorch never donates an argument's "
          "storage to a call, so a tensor stays valid after any call that "
          "took it",
    "R5": "weak-typed scalar retrace: eager PyTorch traces nothing, so a "
          "Python scalar argument never recompiles anything",
}


def fingerprint(rule: str, path: str, symbol: str, line_text: str) -> str:
    """Line-number-independent identity of a finding (the baseline key)."""
    norm = "".join(line_text.split())
    digest = hashlib.sha1(
        f"{rule}|{path}|{symbol}|{norm}".encode()).hexdigest()
    return digest[:16]


@dataclass
class Finding:
    rule: str                 # one of RULE_IDS
    path: str                 # repo-relative posix path
    line: int                 # 1-based
    col: int
    symbol: str               # enclosing function qualname ("<module>" ok)
    message: str
    line_text: str = ""       # stripped source of the offending line
    suppressed_by: Optional[str] = None   # baseline reason / "inline"

    @property
    def fingerprint(self) -> str:
        return fingerprint(self.rule, self.path, self.symbol,
                           self.line_text)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")

    def to_json(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "symbol": self.symbol,
            "message": self.message, "line_text": self.line_text,
            "fingerprint": self.fingerprint,
            "suppressed_by": self.suppressed_by,
        }


@dataclass
class LintResult:
    """The partitioned outcome of one lint run."""

    findings: List[Finding] = field(default_factory=list)    # unsuppressed
    suppressed: List[Finding] = field(default_factory=list)
    files: int = 0
    # baseline entries whose fingerprint matched nothing this run: stale
    # suppressions to prune (reported, never fatal)
    stale_suppressions: List[Dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out
