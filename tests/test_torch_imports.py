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


# the modules that flat mode and the sync-free single env added or
# changed; each is imported first, with no module of the package loaded
FLAT_SLICE_MODULES = (
    "gsc_tpu_torch.agents.adam", "gsc_tpu_torch.agents.buffer",
    "gsc_tpu_torch.agents.ddpg", "gsc_tpu_torch.agents.trainer",
    "gsc_tpu_torch.cli", "gsc_tpu_torch.config.loader",
    "gsc_tpu_torch.config.schema", "gsc_tpu_torch.device",
    "gsc_tpu_torch.env.env", "gsc_tpu_torch.env.observations",
    "gsc_tpu_torch.env.permutation", "gsc_tpu_torch.models.nets",
    "gsc_tpu_torch.obs.learning", "gsc_tpu_torch.ops.substep",
    "gsc_tpu_torch.parallel.dp", "gsc_tpu_torch.serve.policy",
    "gsc_tpu_torch.serve.run", "gsc_tpu_torch.serve.server",
    "gsc_tpu_torch.sim.engine", "gsc_tpu_torch.utils.checkpoint")


def test_flat_slice_modules_import_first_with_jax_blocked():
    for module in FLAT_SLICE_MODULES:
        assert (PKG / (module.split(".", 1)[1].replace(".", "/") + ".py")
                ).is_file(), module
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for mod in {FLAT_SLICE_MODULES!r}:",
        "    for m in [m for m in sys.modules",
        "              if m.split('.')[0] == 'gsc_tpu_torch']:",
        "        del sys.modules[m]",
        "    importlib.import_module(mod)",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
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


# the modules of the default train run and of ``simulate``, which the
# rglob above must keep finding
TRAIN_RUN_MODULES = (
    "obs/sinks.py", "obs/series.py", "obs/hub.py", "obs/device.py",
    "obs/watchdog.py", "obs/endpoint.py", "obs/learning.py",
    "obs/curves.py", "obs/run.py", "resilience/faults.py",
    "resilience/guard.py", "resilience/preempt.py", "resilience/retry.py",
    "utils/experiment.py", "utils/debug.py", "utils/logging.py")


def test_the_default_train_run_runs_with_jax_yaml_and_click_blocked(
        tmp_path):
    """The default single-env loop (prefetcher, observer with the learn
    ledger, rollback guard, a fault plan, invariant checks, the profiler)
    and ``simulate``'s engine path, run in a process where every blocked
    module fails to import: the lazy imports inside them too."""
    for rel in TRAIN_RUN_MODULES:
        assert (PKG / rel).is_file(), rel
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        "from gsc_tpu_torch.agents.trainer import Trainer",
        "from gsc_tpu_torch.config import abc_service",
        "from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,",
        "    SimConfig)",
        "from gsc_tpu_torch.env.driver import EpisodeDriver",
        "from gsc_tpu_torch.env.env import ServiceCoordEnv",
        "from gsc_tpu_torch.obs import RunObserver",
        "from gsc_tpu_torch.resilience.faults import FaultPlan",
        "from gsc_tpu_torch.topology import synthetic",
        "from gsc_tpu_torch.topology.compiler import compile_topology",
        "from gsc_tpu_torch.utils.experiment import ExperimentResult",
        "agent = AgentConfig(episode_steps=3, gnn_features=4,",
        "    gnn_num_layers=1, gnn_num_iter=1, actor_hidden_layer_nodes=(8,),",
        "    critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=6,",
        "    nb_steps_warmup_critic=2)",
        "sim = SimConfig(run_duration=10.0, ttl_choices=(100.0,))",
        "limits = EnvLimits.for_service(abc_service(), max_nodes=8,",
        "    max_edges=8)",
        "env = ServiceCoordEnv(abc_service(), sim, agent, limits)",
        "topo = compile_topology(synthetic.triangle(), max_nodes=8,",
        "    max_edges=8)",
        "driver = EpisodeDriver.single(topo, sim, abc_service(), 3, 'tri')",
        f"obs = RunObserver({str(tmp_path / 'o')!r}, learn=True,",
        "    series_window=16, watchdog_budget_s=60.0).start()",
        "t = Trainer(env, driver, agent, device='cpu', obs=obs,",
        f"    result_dir={str(tmp_path / 'r')!r}, check_invariants=True,",
        "    fault_plan=FaultPlan.parse('nan_grads@1;dispatch_transient@0'))",
        "t.train(3, profile=True)",
        "obs.close()",
        f"ExperimentResult({str(tmp_path / 'r')!r}).write()",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")
    for name in ("events.jsonl", "metrics.json", "series.json",
                 "curves.json"):
        assert (tmp_path / "o" / name).is_file(), name
    assert (tmp_path / "r" / "profile" / "trace.json").is_file()
    assert (tmp_path / "r" / "result.yaml").is_file()


# the generalization path's modules, which the rglob above must keep
# finding
GENERALIZATION_MODULES = (
    "sim/traffic.py", "sim/traffic_device.py", "topology/scenarios.py",
    "topology/factory.py", "env/curriculum.py", "env/permutation.py",
    "env/driver.py", "parallel/dp.py", "parallel/harness.py")


@pytest.mark.parametrize("mix", ["schedule,ring5~link@1.0,random6:3",
                                 "factory:all+shapes~faults"])
def test_generalization_training_runs_with_jax_yaml_and_click_blocked(mix):
    """Replica training under a registry mix (host and device traffic)
    and the scenario factory with the curriculum, node shuffling on, in a
    process where every blocked module fails to import."""
    for rel in GENERALIZATION_MODULES:
        assert (PKG / rel).is_file(), rel
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        "from gsc_tpu_torch.agents.trainer import Trainer",
        "from gsc_tpu_torch.config import abc_service",
        "from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,",
        "    SimConfig)",
        "from gsc_tpu_torch.env.curriculum import CurriculumConfig",
        "from gsc_tpu_torch.env.driver import EpisodeDriver",
        "from gsc_tpu_torch.env.env import ServiceCoordEnv",
        "from gsc_tpu_torch.obs import RunObserver",
        "from gsc_tpu_torch.topology import synthetic",
        "from gsc_tpu_torch.topology.compiler import compile_topology",
        "agent = AgentConfig(episode_steps=2, gnn_features=4,",
        "    gnn_num_layers=1, gnn_num_iter=1, actor_hidden_layer_nodes=(8,),",
        "    critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=8,",
        "    nb_steps_warmup_critic=2, shuffle_nodes=True)",
        "sim = SimConfig(run_duration=10.0, ttl_choices=(100.0,))",
        "limits = EnvLimits.for_service(abc_service(), max_nodes=8,",
        "    max_edges=8)",
        "env = ServiceCoordEnv(abc_service(), sim, agent, limits)",
        "topo = compile_topology(synthetic.triangle(), max_nodes=8,",
        "    max_edges=8)",
        "driver = EpisodeDriver.single(topo, sim, abc_service(), 2, 'tri',",
        f"    topo_mix={mix!r})",
        "obs = RunObserver(None, learn=True).start()",
        "t = Trainer(env, driver, agent, device='cpu', obs=obs)",
        "t.train_parallel(2, 4, chunk=2,",
        "    curriculum=CurriculumConfig(floor=0.5))",
        "if driver.factory_spec is None:",
        "    t.train_parallel(1, 4, chunk=2, device_traffic=False)",
        "obs.close()",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")


# per-flow control and its helpers, which the rglob above must keep finding
PERFLOW_MODULES = ("sim/perflow.py", "sim/spr.py", "sim/predictor.py",
                   "sim/dummy.py", "utils/telemetry.py")


def test_per_flow_control_runs_with_jax_yaml_and_click_blocked(tmp_path):
    """The SPR loop through ``PerFlowController`` (with its flow-action
    CSV), an interval of ``apply_per_flow``, the GRU forecaster, the
    predicted observations and the canned backend, in a process where
    every blocked module fails to import."""
    for rel in PERFLOW_MODULES:
        assert (PKG / rel).is_file(), rel
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        "import numpy as np, torch",
        "from gsc_tpu_torch.config import abc_service",
        "from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,",
        "    SimConfig)",
        "from gsc_tpu_torch.env.env import ServiceCoordEnv",
        "from gsc_tpu_torch.sim import (DummyEngine, PerFlowController,",
        "    RNNTrafficPredictor, SimEngine, generate_traffic)",
        "from gsc_tpu_torch.sim.spr import run_spr_episode",
        "from gsc_tpu_torch.topology import synthetic",
        "from gsc_tpu_torch.topology.compiler import compile_topology",
        "from gsc_tpu_torch.utils.telemetry import TestModeWriter",
        "sim = SimConfig(run_duration=10.0, ttl_choices=(100.0,),",
        "    controller='per_flow', prediction=True)",
        "svc = abc_service()",
        "limits = EnvLimits.for_service(svc, max_nodes=8, max_edges=8)",
        "topo = compile_topology(synthetic.triangle(), max_nodes=8,",
        "    max_edges=8)",
        "traffic = generate_traffic(sim, svc, topo, 4, 0)",
        "eng = SimEngine(svc, sim, limits)",
        f"w = TestModeWriter({str(tmp_path)!r}, write_flow_actions=True)",
        "st = run_spr_episode(PerFlowController(eng, topo, traffic,",
        "    writer=w), eng.init(1, 'cpu'), 30)",
        "w.close()",
        "dec = lambda s: torch.where(s.flows.phase == 1, s.flows.node, -1)",
        "st, m = eng.apply_per_flow(st, topo, traffic,",
        "    lambda s: dec(s).to(torch.int32))",
        "assert int(m.generated[0]) > 0",
        "p = RNNTrafficPredictor(hidden=4)",
        "p.fit(np.arange(6, dtype=np.float32), epochs=3)",
        "assert np.isfinite(p.predict(np.arange(3, dtype=np.float32)))",
        "agent = AgentConfig(episode_steps=2)",
        "for engine in (None, DummyEngine(svc, sim, limits)):",
        "    env = ServiceCoordEnv(svc, sim, agent, limits, engine=engine)",
        "    es, obs = env.reset(topo, traffic)",
        "    assert float(obs.nodes[0, :, 0].max()) > 0",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")
    assert (tmp_path / "flow_actions.csv").read_text().count("\n") > 1


# the plugin and decoupled-training modules, which the rglob above must
# keep finding
PLUGIN_ASYNC_MODULES = ("ops/resource_codegen.py", "parallel/async_rl.py",
                        "config/registry.py", "serve/fleet.py")


def test_plugin_and_async_paths_run_with_jax_yaml_and_click_blocked(
        tmp_path):
    """A resource-function plugin loaded from a file, traced and compiled
    to the kernel's header, the plain engine under it, and
    ``Trainer.train_async`` with two actor threads and a fault plan, in a
    process where every blocked module fails to import."""
    for rel in PLUGIN_ASYNC_MODULES:
        assert (PKG / rel).is_file(), rel
    (tmp_path / "blk_plugin.py").write_text(
        "import torch\n\n\ndef resource_function(load):\n"
        "    return torch.where(load > 1.0, load * load, load)\n")
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        "import dataclasses",
        "from gsc_tpu_torch.agents.trainer import Trainer",
        "from gsc_tpu_torch.config import abc_service",
        "from gsc_tpu_torch.config.registry import "
        "load_resource_function_plugins",
        "from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,",
        "    SimConfig)",
        "from gsc_tpu_torch.env.driver import EpisodeDriver",
        "from gsc_tpu_torch.env.env import ServiceCoordEnv",
        "from gsc_tpu_torch.ops.resource_codegen import kernel_plan",
        "from gsc_tpu_torch.resilience.faults import FaultPlan",
        "from gsc_tpu_torch.sim import cases",
        "from gsc_tpu_torch.topology import synthetic",
        "from gsc_tpu_torch.topology.compiler import compile_topology",
        f"names = load_resource_function_plugins({str(tmp_path)!r})",
        "assert names == ['blk_plugin'], names",
        "case = cases.with_plugins(cases.battery_case('node_cap'),",
        "                          ('blk_plugin',))",
        "ids, header = kernel_plan(case.engine.tables.resource_fns)",
        "assert ids == [2, 2, 2] and 'rf_plugin_2' in header",
        "cases.run_case(dataclasses.replace(case, intervals=1), 'cpu')",
        "agent = AgentConfig(episode_steps=2, gnn_features=4,",
        "    gnn_num_layers=1, gnn_num_iter=1, actor_hidden_layer_nodes=(8,),",
        "    critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=8,",
        "    nb_steps_warmup_critic=2)",
        "sim = SimConfig(run_duration=10.0, ttl_choices=(100.0,))",
        "limits = EnvLimits.for_service(abc_service(), max_nodes=8,",
        "    max_edges=8)",
        "env = ServiceCoordEnv(abc_service(), sim, agent, limits)",
        "topo = compile_topology(synthetic.triangle(), max_nodes=8,",
        "    max_edges=8)",
        "driver = EpisodeDriver.single(topo, sim, abc_service(), 2, 'tri')",
        "t = Trainer(env, driver, agent, device='cpu',",
        "    fault_plan=FaultPlan.parse('ring_poison@1'))",
        "t.train_async(3, 2, chunk=1, actor_threads=2)",
        "assert t.async_info['blocks_quarantined'] == 1, t.async_info",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")


# the mesh path's modules (``train --mesh``), which the rglob above must
# keep finding
MESH_MODULES = ("meshspec.py", "parallel/mesh.py", "parallel/partition.py",
                "parallel/dp.py", "parallel/harness.py", "agents/trainer.py",
                "utils/checkpoint.py", "resilience/ckpt.py", "obs/run.py")


def test_meshspec_imports_without_torch_or_numpy():
    """The mesh grammar is loaded on its own, with torch and numpy
    blocked, and gives the grammar's answers."""
    for rel in MESH_MODULES:
        assert (PKG / rel).is_file(), rel
    code = "\n".join([
        "import importlib.util, sys",
        "for name in ('torch', 'numpy', 'jax', 'gsc_tpu'):",
        "    sys.modules[name] = None",
        "spec = importlib.util.spec_from_file_location(",
        f"    'meshspec', {str(PKG / 'meshspec.py')!r})",
        "mod = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(mod)",
        "assert mod.parse_mesh_shape('4x2') == (4, 2)",
        "assert mod.canonical_mesh(' 8 ') == '8x1'",
        "assert mod.validate_partition_rules('sharded') == 'sharded'",
        "print('ok')",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"


def test_mesh_ranks_import_nothing_of_jax():
    """A launched rank reports the modules its process loaded: none of
    JAX or gsc_tpu beyond what a bare interpreter here preloads."""
    from gsc_tpu_torch.parallel.mesh import launch

    bare = subprocess.run(
        [sys.executable, "-c", "import sys; print(' '.join(sys.modules))"],
        capture_output=True, text=True, timeout=60).stdout.split()
    bare = {m.split(".")[0] for m in bare}
    loaded = launch(_loaded_roots, 2, 1, device="cpu", deadline_s=120)
    for roots in loaded:
        leaked = (roots - bare) & set(FORBIDDEN_ROOTS)
        assert not leaked, leaked


def _loaded_roots(mesh):
    import gsc_tpu_torch.cli  # noqa: F401
    import gsc_tpu_torch.parallel.partition  # noqa: F401
    return {m.split(".")[0] for m in sys.modules}


# the cost ledger's and the sentinels' modules, which the rglob above
# must keep finding
LEDGER_MODULES = ("ops/cost.py", "analysis/__init__.py",
                  "analysis/launches.py", "analysis/sentinels.py",
                  "obs/perf.py")


def test_the_cost_ledger_and_sentinels_run_with_jax_blocked(tmp_path):
    """A ``perf.json`` written by a perf-enabled observer over a pipelined
    and a replica run, each under ``assert_no_retrace``, and the
    ``no_host_sync`` tripwire, in a process where every blocked module
    fails to import."""
    for rel in LEDGER_MODULES:
        assert (PKG / rel).is_file(), rel
    code = "\n".join([
        "import json, sys",
        f"for name in {BLOCKED!r}:",
        "    for mod in [m for m in sys.modules if m == name or "
        "m.startswith(name + '.')]:",
        "        del sys.modules[mod]",
        "    sys.modules[name] = None",
        "import torch",
        "from gsc_tpu_torch.agents.trainer import Trainer",
        "from gsc_tpu_torch.analysis import (HostSyncError,",
        "    assert_no_retrace, no_host_sync)",
        "from gsc_tpu_torch.config import abc_service",
        "from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,",
        "    SimConfig)",
        "from gsc_tpu_torch.env.driver import EpisodeDriver",
        "from gsc_tpu_torch.env.env import ServiceCoordEnv",
        "from gsc_tpu_torch.obs import RunObserver",
        "from gsc_tpu_torch.topology import synthetic",
        "from gsc_tpu_torch.topology.compiler import compile_topology",
        "agent = AgentConfig(episode_steps=3, gnn_features=4,",
        "    gnn_num_layers=1, gnn_num_iter=1, actor_hidden_layer_nodes=(8,),",
        "    critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=6,",
        "    nb_steps_warmup_critic=2, gnn_impl='pallas')",
        "sim = SimConfig(run_duration=10.0, ttl_choices=(100.0,))",
        "limits = EnvLimits.for_service(abc_service(), max_nodes=8,",
        "    max_edges=8)",
        "env = ServiceCoordEnv(abc_service(), sim, agent, limits)",
        "topo = compile_topology(synthetic.triangle(), max_nodes=8,",
        "    max_edges=8)",
        "driver = EpisodeDriver.single(topo, sim, abc_service(), 3, 'tri')",
        # the native traffic sampler loads once, before the regions, as
        # the kernel libraries do on the card
        "from gsc_tpu_torch.native import load_library",
        "load_library()",
        "for name in ('p', 'r'):",
        f"    d = {str(tmp_path)!r} + '/' + name",
        "    obs = RunObserver(d, perf=True).start()",
        "    t = Trainer(env, driver, agent, device='cpu', obs=obs)",
        "    with assert_no_retrace():",
        "        if name == 'p':",
        "            t.train(2)",
        "        else:",
        "            t.train_parallel(2, 2, chunk=1)",
        "    obs.close()",
        "    doc = json.load(open(d + '/perf.json'))",
        "    print(name, sorted(doc['entries']))",
        "try:",
        "    with no_host_sync('blocked'):",
        "        torch.ones(2).sum().item()",
        "except HostSyncError:",
        "    print('tripped')",
        "leaked = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {BLOCKED!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert "p ['episode_step']" in lines
    assert "r ['chunk_step', 'learn_burst']" in lines
    assert lines[-2:] == ["tripped", "ok"]
