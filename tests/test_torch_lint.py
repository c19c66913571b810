"""The port's static analysis (``gsc_tpu_torch.analysis``) against the JAX
package's linter and on its own fixtures.

- R6-R10: the port's ``concur`` gives the JAX package's findings (rule,
  line, symbol, fingerprint) on every
  ``tests/assets/lint_fixtures/concur_*.py`` and on every file of
  ``gsc_tpu_torch/``; fingerprints are the JAX
  package's, so the two baselines mean the same thing;
- R1, R3 and R4 as the port reads them: a snippet that fires and a clean
  one for each (R2 and R5 are dropped: the runner refuses them with exit
  2);
- the baseline round-trips; an entry stamped TODO fails the write; an
  inline marker needs its ``-- <reason>``;
- the runner's exit codes 0, 1 and 2, ``--changed`` and ``--prune-stale``
  as tests/test_concur_lint.py:196-257 hold the JAX runner's;
- the runner over ``gsc_tpu_torch/`` and ``chip_smoke.py`` exits 0 with
  the committed baseline, every entry of which has a written reason, and
  exits 1 on a copy of the package with an ``.item()`` seeded into
  ``DDPG.episode_step`` (R1) or a dispatch outside ``dispatch_lock``
  seeded into a thread-spawning module (R8).

Tolerance: none, every comparison is exact.  Stdlib and the two linters
only: no device, no JAX runtime.
"""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from gsc_tpu.analysis import astlint as j_astlint
from gsc_tpu.analysis.concur import check_concurrency as j_concur
from gsc_tpu.analysis.findings import fingerprint as j_fingerprint

from gsc_tpu_torch.analysis import (DROPPED_RULES, RULE_IDS, STEP_ROOTS,
                                    inline_suppression, lint_files,
                                    load_baseline, save_baseline)
from gsc_tpu_torch.analysis import astlint
from gsc_tpu_torch.analysis.concur import check_concurrency
from gsc_tpu_torch.analysis.findings import fingerprint
from gsc_tpu_torch.analysis.lint import DEFAULT_BASELINE, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "assets", "lint_fixtures")
CONCUR_FIXTURES = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES,
                                                        "concur_*.py")))


def _concur_rows(index_module, check, path):
    rel = os.path.relpath(path, REPO).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return [(f.rule, f.line, f.symbol, f.fingerprint)
            for f in check(index_module(rel, src))]


@pytest.mark.parametrize("name", CONCUR_FIXTURES)
def test_concurrency_rules_match_jax_on_fixture(name):
    path = os.path.join(FIXTURES, name)
    got = _concur_rows(astlint.index_module, check_concurrency, path)
    want = _concur_rows(j_astlint.index_module, j_concur, path)
    assert got == want
    if "clean" not in name and "locked" not in name:
        assert got, "the fixture's seeded violation must fire"


def test_concurrency_rules_match_jax_on_the_port():
    files = astlint._iter_py_files([os.path.join(REPO, "gsc_tpu_torch")])
    assert len(files) > 90
    for path in files:
        assert _concur_rows(astlint.index_module, check_concurrency, path) \
            == _concur_rows(j_astlint.index_module, j_concur, path), path


def test_fingerprints_are_the_jax_packages():
    for args in (("R1", "a/b.py", "C.f", "x = y.item()"),
                 ("R8", "chip_smoke.py", "<module>", "  f( a ,b)  ")):
        assert fingerprint(*args) == j_fingerprint(*args)
    assert set(RULE_IDS) | set(DROPPED_RULES) == set(
        f"R{k}" for k in range(1, 11))


# ----------------------------------------------------------- R1, R3, R4

R1_FIRES = '''
import torch

class DDPG:
    def episode_step(self, state, x):
        helper(x)
        if (x > 0).any():
            pass

def helper(x):
    return float(x.sum()) + x.max().item()
'''
R1_CLEAN = '''
import torch

class DDPG:
    def episode_step(self, state, x, n: int):
        if x is None or n > 2:
            return None
        return helper(x), x.shape[0], int(n)

def helper(x):
    return torch.where(x > 0, x, 0.0).sum()

def not_a_step(x):
    return x.item()
'''
R3_FIRES = '''
import time
import numpy as np
import torch

class ServiceCoordEnv:
    def step(self, state, g):
        t0 = time.perf_counter()
        noise = torch.randn(3) + np.random.rand()
        return state.normal_(), noise, t0
'''
R3_CLEAN = '''
import numpy as np
import torch

class ServiceCoordEnv:
    def step(self, state, g):
        rng = np.random.default_rng(0)
        return torch.randn(3, generator=g), state.normal_(generator=g), rng
'''
R4_FIRES = '''
import torch
import torch.nn.functional as F

def project(x, w, cd=None):
    return F.linear(x.to(cd), w.to(cd))

def pair(a, b):
    return torch.einsum("ij,jk->ik", a, b) + a @ b
'''
R4_CLEAN = '''
import torch
import torch.nn.functional as F

def project(x, w, cd=None):
    if cd is None:
        return F.linear(x, w)
    return F.linear(x.to(cd).float(), w.to(cd).float())

def attention(xl, att):
    if xl.dtype == torch.bfloat16:
        return attention_bf16(xl, att)
    return torch.einsum("ijf,f->ij", xl, att)

def attention_bf16(xl, att, wide: torch.dtype = torch.float32):
    logits = torch.einsum("ijf,f->ij", xl.to(wide), att.float())
    a = logits.to(torch.bfloat16).to(wide)
    return torch.einsum("ij,jf->if", a, xl.to(wide) * 2)
'''
RULE_CASES = {"R1": (R1_FIRES, R1_CLEAN, 3), "R3": (R3_FIRES, R3_CLEAN, 4),
              "R4": (R4_FIRES, R4_CLEAN, 3)}


def _lint_snippet(tmp_path, src, rule):
    d = tmp_path / "pkg" / "ops"
    d.mkdir(parents=True)
    (d / "mod.py").write_text(textwrap.dedent(src))
    raw, n = lint_files([str(d / "mod.py")], rules={rule},
                        root=str(tmp_path))
    assert n == 1
    return raw


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
@pytest.mark.parametrize("clean", [False, True], ids=["fires", "clean"])
def test_step_and_policy_rules(tmp_path, rule, clean):
    fires, quiet, count = RULE_CASES[rule]
    raw = _lint_snippet(tmp_path, quiet if clean else fires, rule)
    if clean:
        assert raw == [], [f.format() for f in raw]
    else:
        assert len(raw) == count, [f.format() for f in raw]
        assert {f.rule for f in raw} == {rule}


def test_r1_follows_calls_by_type(tmp_path):
    """A sync two calls away, through an annotated attribute's method and
    an instance called as a module, is reached from the step root."""
    src = '''
    import torch

    class Net:
        def forward(self, x):
            return x.cpu()

    class Engine:
        def apply(self, x):
            return x.tolist()

    class ServiceCoordEnv:
        def __init__(self, engine: Engine):
            self.engine = engine
            self.net = Net()

        def reset(self, x):
            return self.engine.apply(self.net(x))
    '''
    raw = _lint_snippet(tmp_path, src, "R1")
    assert sorted(f.symbol for f in raw) == ["Engine.apply", "Net.forward"]
    assert all("ServiceCoordEnv.reset" in f.message for f in raw)
    assert "ServiceCoordEnv.reset" in STEP_ROOTS


# ------------------------------------------------------------- baseline

def test_baseline_round_trip_and_inline_reasons(tmp_path):
    raw = _lint_snippet(tmp_path, R1_FIRES, "R1")
    bl = tmp_path / "bl.json"
    assert save_baseline(str(bl), raw) == len({f.fingerprint for f in raw})
    entries = load_baseline(str(bl))
    assert all(e["reason"].startswith("TODO") for e in entries)
    for e in entries:
        e["reason"] = "accepted in this test"
    bl.write_text(json.dumps({"version": 1, "suppressions": entries}))
    save_baseline(str(bl), raw, existing=load_baseline(str(bl)))
    again = load_baseline(str(bl))
    assert again == entries
    bl.write_text(json.dumps({"version": 1, "suppressions": [
        dict(entries[0], reason="")]}))
    with pytest.raises(ValueError, match="no reason"):
        load_baseline(str(bl))
    assert inline_suppression("x.item()  # gsc-lint: disable=R1 -- why",
                              "R1")
    assert not inline_suppression("x.item()  # gsc-lint: disable=R1", "R1")


def test_committed_baseline_has_a_reason_per_entry():
    entries = load_baseline(DEFAULT_BASELINE)
    assert entries
    for e in entries:
        assert e["reason"] and not e["reason"].startswith("TODO"), e
        assert e["rule"] in RULE_IDS
    r8 = [e for e in entries if e["rule"] == "R8"
          and e["path"] == "gsc_tpu_torch/parallel/async_rl.py"]
    assert len(r8) == 3
    assert all("cli.py:437" in e["reason"] for e in r8)


# --------------------------------------------------------------- runner

def _fixture(name):
    return os.path.join(FIXTURES, name)


def test_runner_is_clean_on_the_port(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "stale" not in out


def test_runner_exit_codes(tmp_path, capsys):
    bl = str(tmp_path / "none.json")
    assert main(["--baseline", bl, "-q",
                 _fixture("concur_r8_locked.py")]) == 0
    assert main(["--baseline", bl, "-q",
                 _fixture("concur_r8_dispatch.py")]) == 1
    for argv in (["--rules", "R2"], ["--rules", "R11"],
                 [str(tmp_path / "missing.py")],
                 ["--no-baseline", "--prune-stale"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2, argv
    err = capsys.readouterr().err
    assert "R2 is dropped in the port" in err


def test_write_baseline_with_todo_exits_1(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    fixture = _fixture("concur_r9_blocking.py")
    assert main(["--baseline", str(bl), "--write-baseline", fixture]) == 1
    assert "need a written reason" in capsys.readouterr().out
    doc = json.loads(bl.read_text())
    doc["suppressions"] = [dict(e, reason="accepted") for e in
                           doc["suppressions"]]
    bl.write_text(json.dumps(doc))
    assert main(["--baseline", str(bl), "--write-baseline", fixture]) == 0
    assert main(["--baseline", str(bl), fixture]) == 0


def test_changed_falls_back_to_full_scan_on_bad_ref(tmp_path, capsys):
    assert main(["--changed", "this-ref-does-not-exist",
                 _fixture("concur_r6_clean.py")]) == 0
    out = capsys.readouterr()
    assert "falling back to a full scan" in out.err
    assert "1 files, 0 finding(s)" in out.out


def test_changed_scopes_to_git_diff(capsys):
    """--changed REF lints at most the files in the diff; against HEAD the
    run stays clean."""
    assert main(["--changed", "HEAD", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["findings"] == []
    full = astlint._iter_py_files([os.path.join(REPO, "gsc_tpu_torch"),
                                   os.path.join(REPO, "chip_smoke.py")])
    assert doc["files"] <= len(full)


def test_prune_stale_drops_only_in_scope_entries(tmp_path, capsys):
    fixture = _fixture("concur_r9_blocking.py")
    raw, _ = lint_files([fixture], root=REPO)
    assert len(raw) == 3
    bl = tmp_path / "baseline.json"
    save_baseline(str(bl), raw)
    entries = load_baseline(str(bl))
    rel = os.path.relpath(fixture, REPO).replace(os.sep, "/")
    entries.append({"fingerprint": "feedfacefeedface", "rule": "R9",
                    "path": rel, "line_text": "gone()",
                    "reason": "stale: in linted scope"})
    entries.append({"fingerprint": "cafebabecafebabe", "rule": "R1",
                    "path": "gsc_tpu_torch/never_linted_here.py",
                    "line_text": "x.item()",
                    "reason": "out of scope: must survive"})
    bl.write_text(json.dumps({"version": 1, "suppressions": entries}))
    assert main(["--baseline", str(bl), fixture]) == 0
    assert "1 stale" in capsys.readouterr().out
    assert main(["--baseline", str(bl), "--prune-stale", fixture]) == 0
    assert "pruned 1 stale suppression(s)" in capsys.readouterr().out
    after = {e["fingerprint"] for e in load_baseline(str(bl))}
    assert "feedfacefeedface" not in after
    assert "cafebabecafebabe" in after
    assert {f.fingerprint for f in raw} <= after
    before = bl.read_bytes()
    assert main(["--baseline", str(bl), "--prune-stale", fixture]) == 0
    assert "pruned 0 stale suppression(s)" in capsys.readouterr().out
    assert bl.read_bytes() == before


def _seeded_copy(tmp_path, rel, anchor, line):
    """A copy of the package with ``line`` inserted after
    the first line of ``rel`` that contains ``anchor``, indented as the
    line after it."""
    shutil.copytree(os.path.join(REPO, "gsc_tpu_torch"),
                    tmp_path / "gsc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = tmp_path / rel
    lines = path.read_text().splitlines(keepends=True)
    at = next(i for i, ln in enumerate(lines) if anchor in ln)
    nxt = lines[at + 1]
    indent = nxt[:len(nxt) - len(nxt.lstrip())]
    lines.insert(at + 1, indent + line + "\n")
    path.write_text("".join(lines))
    ast.parse(path.read_text())
    return tmp_path


@pytest.mark.parametrize("seed", ["R1", "R8"])
def test_runner_exits_1_on_a_seeded_copy(tmp_path, capsys, seed):
    if seed == "R1":
        root = _seeded_copy(tmp_path, "gsc_tpu_torch/agents/ddpg.py",
                            "watch = observe or", "episode_start_step.item()")
    else:
        root = _seeded_copy(tmp_path, "gsc_tpu_torch/parallel/async_rl.py",
                            "def outstanding(self) -> int:",
                            "self.pddpg.learn_burst(None, None)")
    assert main(["--rules", seed, str(root / "gsc_tpu_torch")],
                root=str(root)) == 1
    out = capsys.readouterr().out
    assert f" {seed} " in out and "1 finding(s)" in out


def test_module_entry_point():
    res = subprocess.run(
        [sys.executable, "-m", "gsc_tpu_torch.analysis.lint", "-q",
         "--no-baseline", _fixture("concur_r10_thread.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 1, res.stderr
    assert " R10 " in res.stdout
