"""Resource-function plugins in the port against the JAX package.

- both plugin styles load in the port (a ``resource_function(load)`` file
  registered under its stem, a file that registers itself), and the same
  reference-style file loads in both packages and computes the same;
  ``load_service`` loads plugins before it parses the catalog;
- the port's plain engine against the JAX package's ``SimEngine`` (its
  Pallas kernel's body, as tests/test_torch_substep.py runs it) on the
  same traffic, under a quadratic, a capped ``where`` and a square root
  with a division in the three SF columns, at B = 1 and 4, and under
  per-flow control (the local policy, tests/test_torch_perflow.py's
  line);
- the traced graph (``ops.resource_codegen``) bit for bit equal to the
  plugin on a grid of loads (0, negatives, subnormals, 1e30, infinities,
  NaN: NaN equal to NaN, any other value by its bits), for plugins within
  the compiled set; a plugin with a square root runs its graph, whose
  square root is IEEE's (torch's CPU ``sqrt`` is not correctly rounded on
  f32, which the test counts);
- the generated CUDA text and the library digest the same twice, and no
  header without plugins;
- an operation outside the set refused with its name, on the card's
  path only (the plain engine still runs it on the CPU);
- ``--resource-functions-path`` on ``train``, ``infer``, ``serve`` and
  ``simulate``, ``simulate``'s JSON equal to the JAX CLI's.

The tests marked ``cuda`` need a card and import no JAX: on the card,
``python -m pytest --noconftest tests/test_torch_resource_plugins.py -q
-m cuda`` holds kernel #2's plugin build against its plain version bit
for bit on CPU copies (two battery cases and a per-flow case) and checks
the refusal on the card.

Tolerances: integers and booleans exact; float state rtol 1e-5, atol
1e-5, the bar of tests/test_torch_substep.py (the port's sums may add in
another order than XLA's contractions); ``avg_end2end_delay`` rel 1e-6 as
tests/test_torch_cli_run.py holds it.
"""
import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.config import registry
from gsc_tpu_torch.ops import resource_codegen as rc
from gsc_tpu_torch.ops.build import NVCC_FLAGS, library_digest
from gsc_tpu_torch.ops.substep import SOURCE, resource_plan
from gsc_tpu_torch.sim import cases
from torch_port_helpers import one_torch_thread  # noqa: F401


def _quadratic(load):
    return load * load * 0.5 + load


def _ratio(load):
    return load / 3.0 + load * load / (load + 4.0)


def _capped_t(load):
    return torch.where(load > 2.0, 2.0 + 0.5 * (load - 2.0), load)


def _sqrt_t(load):
    return torch.sqrt(torch.relu(load)) + load / 3.0


def _capped_j(load):
    import jax.numpy as jnp
    return jnp.where(load > 2.0, 2.0 + 0.5 * (load - 2.0), load)


def _sqrt_j(load):
    import jax.numpy as jnp
    return jnp.sqrt(jnp.maximum(load, 0.0)) + load / 3.0


# name -> (port function, JAX function); operator-only ones are shared
PLUGINS = {"tp_quadratic": (_quadratic, _quadratic),
           "tp_capped": (_capped_t, _capped_j),
           "tp_sqrt_ratio": (_sqrt_t, _sqrt_j),
           "tp_ratio": (_ratio, _ratio)}
COLUMNS = ("tp_quadratic", "tp_capped", "tp_sqrt_ratio")


@pytest.fixture(scope="module", autouse=True)
def registered():
    for name, (t_fn, _) in PLUGINS.items():
        registry.register_resource_function(name)(t_fn)


def _register_jax():
    from gsc_tpu.config.registry import register_resource_function as j_reg

    for name, (_, j_fn) in PLUGINS.items():
        j_reg(name)(j_fn)


def _grid():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 1e-40, -1e-40, 1e-45,
                        1e30, -1e30, np.inf, -np.inf, np.nan, 0.1, 3.0],
                       np.float32)
    return torch.from_numpy(np.concatenate([
        special, (rng.standard_normal(4000) * 10).astype(np.float32),
        (rng.random(4000) * 4).astype(np.float32),
        (rng.standard_normal(500) * 1e20).astype(np.float32)]))


def _same_bits(a, b):
    a, b = a.numpy(), b.numpy()
    nan = np.isnan(a)
    return bool(((nan == np.isnan(b)) & (nan | (a.view(np.uint32)
                                                == b.view(np.uint32)))).all())


# ----------------------------------------------------------- the registry
def test_plugin_styles_load_in_both_packages(tmp_path):
    from gsc_tpu.config.registry import \
        get_resource_function as j_get
    from gsc_tpu.config.registry import \
        load_resource_function_plugins as j_load

    from gsc_tpu_torch.config.loader import load_service

    plug = tmp_path / "plugins"
    plug.mkdir()
    (plug / "pl_square.py").write_text(
        "def resource_function(load):\n    return load * load\n")
    (plug / "pl_explicit.py").write_text(
        "import torch\n"
        "from gsc_tpu_torch.config.registry import "
        "register_resource_function\n"
        "@register_resource_function('pl_capped')\n"
        "def _capped(load):\n"
        "    return torch.minimum(load, torch.full_like(load, 3.0))\n")
    names = registry.load_resource_function_plugins(str(plug))
    assert set(names) == {"pl_square", "pl_capped"}
    x = torch.tensor([0.5, 2.0, 5.0])
    assert registry.get_resource_function("pl_square")(x).tolist() == \
        [0.25, 4.0, 25.0]
    assert registry.get_resource_function("pl_capped")(x).tolist() == \
        [0.5, 2.0, 3.0]
    # the same reference-style file in the JAX package
    assert j_load(str(plug / "pl_square.py")) == ["pl_square"]
    np.testing.assert_array_equal(
        np.asarray(j_get("pl_square")(np.asarray(x.numpy()))),
        registry.get_resource_function("pl_square")(x).numpy())
    svc = tmp_path / "svc.yaml"
    svc.write_text("sfc_list:\n  s: [a]\nsf_list:\n  a:\n"
                   "    processing_delay_mean: 5.0\n"
                   "    resource_function_id: pl_file_plugin\n")
    (tmp_path / "pl_file_plugin.py").write_text(
        "def resource_function(load):\n    return load + 1.0\n")
    assert load_service(str(svc)).sf_list["a"].resource_function_id == \
        "default"
    got = load_service(str(svc), resource_functions_path=str(
        tmp_path / "pl_file_plugin.py"))
    assert got.sf_list["a"].resource_function_id == "pl_file_plugin"


# ----------------------------------------------- the engines under plugins
@pytest.mark.parametrize("batch", [1, 4])
def test_plain_engine_matches_jax_under_plugins(batch):
    from test_torch_substep import _run_both

    _register_jax()
    case = cases.with_plugins(cases.abilene_case(batch=batch, intervals=2),
                              COLUMNS)
    fns = case.engine.tables.resource_fns
    assert isinstance(fns[2], rc.ResourceProgram) and fns[0] is _quadratic
    tstate = _run_both(case)
    base = cases.run_case(cases.abilene_case(batch=batch, intervals=2),
                          "cpu")[-1]
    # the plugins changed what the replicas admitted
    assert not torch.equal(tstate.metrics.drop_reasons,
                           base.metrics.drop_reasons) \
        or not torch.equal(tstate.node_load, base.node_load)


def test_per_flow_control_matches_jax_under_plugins():
    import jax
    import jax.numpy as jnp

    from gsc_tpu.config.schema import ServiceConfig as JS
    from gsc_tpu.config.schema import ServiceFunction as JF
    from gsc_tpu.sim import SimEngine as JEngine
    from gsc_tpu.sim.state import PH_DECIDE as J_DECIDE
    from test_torch_perflow import Pair, compare

    from gsc_tpu_torch.config.schema import ServiceConfig, ServiceFunction
    from gsc_tpu_torch.sim import SimEngine
    from gsc_tpu_torch.sim.state import PH_DECIDE

    _register_jax()
    p = Pair(controller="per_flow", inter_arrival_mean=2.0)

    def svc(S, F):
        return S(sfc_list={"sfc_1": ("a", "b", "c")}, sf_list={
            n: F(name=n, processing_delay_mean=5.0,
                 processing_delay_stdev=0.0, resource_function_id=rf)
            for n, rf in zip("abc", ("tp_quadratic", "tp_ratio",
                                     "tp_quadratic"))})

    p.jeng = JEngine(svc(JS, JF), p.jeng.cfg, p.jeng.limits)
    p.eng = SimEngine(svc(ServiceConfig, ServiceFunction), p.eng.cfg,
                      p.eng.limits)
    chain_len = p.eng.tables.chain_len

    def j_decide(st):
        f = st.flows
        wants = (f.phase == J_DECIDE) & (f.position
                                         < jnp.asarray(chain_len)[f.sfc])
        return jnp.where(wants, 1, -1).astype(jnp.int32)

    def t_decide(st):
        f = st.flows
        wants = (f.phase == PH_DECIDE) & (
            f.position < torch.as_tensor(chain_len)[f.sfc.long()])
        return torch.where(wants, 1, -1).to(torch.int32)

    js, ts = p.init()
    run = jax.jit(lambda s: p.jeng.apply_per_flow(s, p.jtopo, p.jtraffic,
                                                  j_decide))
    for i in range(2):
        js, _ = run(js)
        ts, tm = p.eng.apply_per_flow(ts, p.topo, p.traffic, t_decide)
        compare(js, ts, f"interval {i}")
    assert int(tm.generated[0]) > 0 and int(tm.drop_reasons[0, 3]) > 0


# ------------------------------------------------------------ the codegen
@pytest.mark.parametrize("name", ["tp_quadratic", "tp_capped", "tp_ratio",
                                  "overhead_like", "pow_forms",
                                  "clamps", "logic"])
def test_traced_graph_bit_equal_to_plugin(name):
    fn = {"overhead_like": lambda l: torch.where(
              l > 0, 1.0 + 1.2 * l, torch.zeros_like(l)),
          "pow_forms": lambda l: (l ** 3 - l ** -2 + torch.pow(l, 2)
                                  + l ** -1 + torch.square(l) + l ** 0
                                  + 2.0 / l - 0.3 / (l + 1.0)),
          "clamps": lambda l: (torch.clamp(l, 0.2, 2.0) + torch.relu(l - 1)
                               + l.clamp(min=0.1) + torch.clamp(l, max=1.5)
                               + torch.maximum(l, 1.0 - l)
                               - torch.minimum(l * 2, torch.ones_like(l))),
          "logic": lambda l: (torch.where((l > 0) & ~(l >= 2), l, -abs(l))
                              + (l < 1).float() * 3 + (l != 0.5) * 0.25)
          }.get(name) or PLUGINS[name][0]
    prog = rc.trace(fn, name)
    assert not prog.uses_graph
    x = _grid()
    assert _same_bits(prog.evaluate(x), fn(x))


def test_square_root_runs_its_traced_graph():
    prog = rc.trace(_sqrt_t, "tp_sqrt_ratio")
    assert prog.uses_graph
    assert rc.plain_form(_sqrt_t).fn is _sqrt_t
    x = _grid()
    want = np.sqrt(torch.relu(x).numpy()) + x.numpy() / np.float32(3)
    assert _same_bits(prog.evaluate(x), torch.from_numpy(want))
    # torch's f32 sqrt on this CPU: how many loads lie off IEEE's (not
    # asserted: the CPU's build decides), the reason for the graph
    y = torch.rand(100_000, generator=torch.Generator().manual_seed(0)) * 100
    off = int((torch.sqrt(y).numpy().view(np.uint32)
               != np.sqrt(y.numpy()).view(np.uint32)).sum())
    assert 0 <= off < 100_000


def test_generated_header_and_digest_stable():
    plug = cases.with_plugins(cases.abilene_case(batch=1, intervals=1),
                              COLUMNS)
    ids, header = rc.kernel_plan(plug.engine.tables.resource_fns)
    ids2, header2 = rc.kernel_plan(plug.engine.tables.resource_fns)
    assert ids == ids2 == [2, 3, 4]
    assert header == header2 and "rf_plugin_4" in header
    assert "__fsqrt_rn" in header and "__fmul_rn" in header
    flags = tuple(NVCC_FLAGS) + ("-fmad=false", "-DSUBSTEP_RF_PLUGINS")
    gen = {rc.HEADER_NAME: header}
    assert library_digest(SOURCE, flags, gen) == \
        library_digest(SOURCE, flags, dict(gen))
    assert library_digest(SOURCE, flags, gen) != \
        library_digest(SOURCE, flags)
    # the same plugin in two columns takes one id
    twice = cases.with_plugins(cases.abilene_case(batch=1, intervals=1),
                               ("tp_quadratic",))
    assert rc.kernel_plan(twice.engine.tables.resource_fns)[0] == [2, 2, 2]
    # built-ins only: no header, the kernel's own build
    base = cases.abilene_case(batch=1, intervals=1)
    tabs = resource_plan(base.engine, "cpu")
    assert tabs["rf_header"] is None and tabs["rf_id"].tolist() == [0, 0, 0]
    assert hashlib.sha256(header.encode()).hexdigest() == \
        hashlib.sha256(header2.encode()).hexdigest()


@pytest.mark.parametrize("fn,op", [
    (lambda l: torch.exp(l), "exp"), (lambda l: torch.log(l + 1), "log"),
    (lambda l: torch.tanh(l) * 2, "tanh"), (lambda l: l ** 4, "exponent 4"),
    (lambda l: l if l.sum() > 0 else -l, "does not trace"),
    (lambda l: 2 ** l, "tensor exponent")])
def test_out_of_set_operation_refused_with_its_name(fn, op):
    with pytest.raises(rc.UnsupportedResourceFunction, match=op):
        rc.trace(fn, "bad")
    registry.register_resource_function("tp_refused")(fn)
    case = cases.with_plugins(cases.battery_case("node_cap"),
                              ("tp_refused",))
    # the card's path refuses it; the plain engine still runs it
    with pytest.raises(rc.UnsupportedResourceFunction, match=op):
        resource_plan(case.engine, "cpu")
    if op != "does not trace":
        assert cases.run_case(dataclasses.replace(case, intervals=1),
                              "cpu")[-1].t.item() > 0


# ----------------------------------------------------------------- the CLI
def test_resource_functions_path_on_every_command(tmp_path, capsys):
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli
    from test_torch_cli_run import SIM_YAML
    from test_torch_single_env import TINY_AGENT

    from gsc_tpu_torch.topology.synthetic import abilene, write_graphml

    plug = tmp_path / "plugins"
    plug.mkdir()
    (plug / "cli_quadratic.py").write_text(
        "def resource_function(load):\n    return load * load * 0.5 + load\n")
    (plug / "cli_ratio.py").write_text(
        "def resource_function(load):\n"
        "    return load / 3.0 + load * load / (load + 4.0)\n")
    svc = tmp_path / "svc.yaml"
    svc.write_text("sfc_list:\n  sfc_1: [a, b, c]\nsf_list:\n" + "".join(
        f"  {n}:\n    processing_delay_mean: 5.0\n"
        f"    processing_delay_stdev: 0.0\n    resource_function_id: {rf}\n"
        for n, rf in zip("abc", ("cli_quadratic", "cli_ratio",
                                 "cli_quadratic"))))
    net = tmp_path / "abilene.graphml"
    write_graphml(abilene(), str(net))
    (tmp_path / "sim.yaml").write_text(SIM_YAML)
    args = ["-d", "500", "-n", str(net), "-sf", str(svc), "-c",
            str(tmp_path / "sim.yaml"), "--resource-functions-path",
            str(plug)]
    res = CliRunner().invoke(j_cli, ["simulate", *args],
                             catch_exceptions=False)
    want = json.loads(res.output.strip().splitlines()[-1])
    assert cli.main(["simulate", *args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("total_flows", "successful_flows", "dropped_flows",
              "drop_reasons"):
        assert got[k] == want[k], k
    assert got["avg_end2end_delay"] == pytest.approx(
        want["avg_end2end_delay"], rel=1e-6)
    assert got["drop_reasons"]["NODE_CAP"] > 0
    # train, infer and serve load the plugins before the catalog
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    common = ["--device", "cpu", "--agent-config",
              str(tmp_path / "agent.yaml"), "--service", str(svc),
              "--resource-functions-path", str(plug)]
    out = cli.run_train(common + ["--replicas", "2", "--chunk", "3",
                                  "--episodes", "1", "--no-obs",
                                  "--result-dir", str(tmp_path / "r")])
    fns = out["trainer"].env.engine.tables.resource_fns
    assert [f.__name__ for f in fns] == ["resource_function"] * 3
    inf = cli.run_infer(common + ["--checkpoint",
                                  str(tmp_path / "r" / "checkpoint")])
    assert np.isfinite(inf["eval"]["mean_return"])
    assert inf["trainer"].env.engine.tables.resource_fns[1] is fns[1]
    capsys.readouterr()
    assert cli.main(["serve", *common, "--requests", "4", "--concurrency",
                     "2", "--pool-steps", "2", "--no-obs"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["completed"] == 4


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node_cap", "abilene_b4", "perflow"])
def test_plugin_kernel_bit_equal_to_plain(name):
    from gsc_tpu_torch.ops.substep import substep_megakernel

    dev = _card()
    if name == "perflow":
        case = cases.with_plugins(cases.perflow_random_case(
            batch=8, substeps=120))
        got = cases.run_perflow_case(case, dev)
        want = cases.run_perflow_case(case, "cpu", plain=True)
    else:
        case = cases.with_plugins(
            cases.battery_case(name) if name == "node_cap"
            else cases.abilene_case(batch=4, intervals=2))
        before = substep_megakernel.plugin_launches
        got = cases.run_case(case, dev)
        assert substep_megakernel.plugin_launches - before == case.intervals
        want = cases.run_case(case, "cpu", plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert cases.bit_equal(g.to("cpu"), w), f"{name} record {i}"


@pytest.mark.cuda
def test_out_of_set_plugin_refused_on_the_card():
    dev = _card()
    calls = []

    def exp_plugin(load):
        if isinstance(load, torch.Tensor):
            calls.append(load.device.type)
        return torch.exp(load)

    registry.register_resource_function("tp_card_exp")(exp_plugin)
    case = cases.with_plugins(cases.battery_case("node_cap"),
                              ("tp_card_exp",))
    with pytest.raises(rc.UnsupportedResourceFunction, match="exp"):
        cases.run_case(case, dev)
    assert calls == []
