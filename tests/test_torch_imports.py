"""The port stands alone: ``gsc_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX (jax, flax, optax, orbax) nor of the ``gsc_tpu`` package,
and need neither yaml, click nor networkx, none of which the card's
machine is promised to have.  Its entry points run on the card by default
and raise without one."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gsc_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "gsc_tpu", "yaml",
           "click", "networkx")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "gsc_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_gsc_tpu_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        f"for mod in {modules!r}:",
        "    importlib.import_module(mod)",
        "import runpy",
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import_check')",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok', len(" f"{modules!r}" "))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_gsc_tpu_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_ROOTS, \
                f"{path.name}:{node.lineno} imports {name}"


def test_default_device_is_the_card_and_raises_without_one():
    from gsc_tpu_torch.agents.ddpg import DDPG
    from gsc_tpu_torch.config import (EnvLimits, abc_service,
                                      init_configs_agent, init_configs_sim)
    from gsc_tpu_torch.device import resolve_device
    from gsc_tpu_torch.env.env import ServiceCoordEnv

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    env = ServiceCoordEnv(abc_service(), init_configs_sim(),
                          init_configs_agent(),
                          EnvLimits.for_service(abc_service()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DDPG(env, init_configs_agent())
    assert resolve_device("cpu").type == "cpu"
