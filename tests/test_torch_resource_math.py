"""Kernel #2's elementwise functions of resource-function plugins
(``csrc/rf_math.cuh``, plain version ``ops/rf_math.py``) against numpy
and the JAX package.

- each function's traced-graph value (``ResourceProgram.evaluate``, the
  plain engine's) on a grid of f32 loads (0, -0, +-subnormals, negatives,
  1e-30 to 1e30, +-inf, NaN) against numpy's float64 function rounded to
  f32: the largest gap is 0 ulps on this grid (asserted <= 1: the double
  form is within a few double ulps of the exact value, not proven
  correctly rounded);
- the same grid against the JAX package's f32 functions (``jnp.exp``
  and kin, XLA's, not correctly rounded either), without subnormal
  inputs or results, which XLA's CPU flushes to zero.  Largest gaps
  measured (ulps): exp 4 (at 88.7, by f32 overflow; 1 elsewhere), expm1
  5, log 1, log1p 2, log2 2, log10 2, tanh 4, sigmoid 2, pow 1; exp2 67,
  where XLA's f32 exp2 is exp(x ln 2) and loses about log2|x| bits.
  Asserted: ``JNP_ULPS``;
- ``plain_form`` routes every new op through the traced graph;
- the header's constants equal the plain version's, the generated plugin
  header is the same twice, and the library digest changes with
  ``rf_math.cuh``;
- the plain engine under ``cases.MATH_PLUGINS`` (a saturating tanh, a
  log1p overhead, ``load ** 1.5`` behind a where) against the JAX
  ``SimEngine`` with jnp twins of those plugins, at B = 1 and 4 and
  under per-flow control: integers exact, float state rtol/atol 1e-5, the
  bar of tests/test_torch_substep.py.  No load was chosen to avoid an
  admission boundary: on these cases no demand lies within the few ulps
  the two sides differ by of a capacity.

The tests marked ``cuda`` need a card and import no JAX: ``python -m
pytest --noconftest tests/test_torch_resource_math.py -q -m cuda`` holds
the header's functions on the card (the probe kernel
``csrc/rf_math_probe.cu``) against the plain version bit for bit on the
grid, and kernel #2's plugin build under ``MATH_PLUGINS`` against its
plain version bit for bit on CPU copies of two battery cases and a
per-flow case.
"""
import re
import shutil

import numpy as np
import pytest
import torch

from gsc_tpu_torch.config import registry
from gsc_tpu_torch.ops import rf_math
from gsc_tpu_torch.ops import resource_codegen as rc
from gsc_tpu_torch.ops.build import NVCC_FLAGS, PKG, library_digest
from gsc_tpu_torch.ops.rf_math_probe import card_values
from gsc_tpu_torch.sim import cases
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY = np.finfo(np.float32).tiny
# the most ulps between the double forms and jnp's f32 functions
JNP_ULPS = {"exp": 4, "expm1": 8, "exp2": 72, "log": 2, "log1p": 4,
            "log2": 4, "log10": 4, "tanh": 8, "sigmoid": 4, "pow": 2}
# one plugin per op, its numpy float64 reference and its jnp form
OPS = {
    "exp": (lambda l: torch.exp(l), np.exp, "exp"),
    "expm1": (lambda l: l.expm1(), np.expm1, "expm1"),
    "exp2": (lambda l: torch.special.exp2(l), np.exp2, "exp2"),
    "log": (lambda l: torch.log(l), np.log, "log"),
    "log1p": (lambda l: torch.log1p(l), np.log1p, "log1p"),
    "log2": (lambda l: l.log2(), np.log2, "log2"),
    "log10": (lambda l: torch.log10(l), np.log10, "log10"),
    "tanh": (lambda l: torch.tanh(l), np.tanh, "tanh"),
    "sigmoid": (lambda l: torch.sigmoid(l),
                lambda v: 1.0 / (1.0 + np.exp(-v)), "sigmoid"),
}
EXPONENTS = (1.5, -1.5, 0.3, 2.5, 4.0, 7.0, -3.5)


def _grid(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 1e-40, -1e-40,
                        1e-45, -1e-45, 1e-30, -1e-30, 1e30, -1e30, np.inf,
                        -np.inf, np.nan, 0.1, 3.0, 88.7, 89.0, -87.0,
                        -103.0, -104.0, -0.25, 0.375, -0.999, 20.0, -20.0],
                       np.float32)
    mag = 10.0 ** rng.uniform(-30, 30, n)
    return np.concatenate([
        special, (rng.standard_normal(n) * 10).astype(np.float32),
        (rng.random(n) * 4).astype(np.float32), mag.astype(np.float32),
        (-mag[: n // 2]).astype(np.float32),
        rng.uniform(-110, 95, n).astype(np.float32)])


def _ulps(a, b):
    """|a - b| in f32 ulps (NaN equal to NaN, NaN against a number
    huge)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)

    def key(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(key(a) - key(b))
    d = np.where(np.isnan(a) & np.isnan(b), 0, d)
    return np.where(np.isnan(a) != np.isnan(b), 1 << 40, d)


def _normal(*arrays):
    """Elements where no array holds a subnormal."""
    ok = np.ones(arrays[0].shape, bool)
    for v in arrays:
        v = np.asarray(v, np.float32)
        ok &= ~((np.abs(v) < TINY) & (v != 0))
    return ok


def _pow_plugin(e):
    return lambda l: l ** e


# ------------------------------------------------------- the functions
@pytest.mark.parametrize("op", sorted(OPS))
def test_graph_value_against_numpy_float64(op):
    fn, ref, _ = OPS[op]
    prog = rc.trace(fn, op)
    assert [n.op for n in prog.nodes] == ["load", op] and prog.uses_graph
    x = _grid()
    got = prog.evaluate(torch.from_numpy(x)).numpy()
    with np.errstate(all="ignore"):
        want = ref(x.astype(np.float64)).astype(np.float32)
    assert _ulps(got, want).max() <= 1
    # the signed zeros the C library keeps
    z = prog.evaluate(torch.tensor([-0.0])).numpy()
    if op in ("expm1", "log1p", "tanh"):
        assert np.signbit(z[0]) and z[0] == 0.0


@pytest.mark.parametrize("e", EXPONENTS)
def test_pow_graph_value_against_numpy_float64(e):
    prog = rc.trace(_pow_plugin(e), f"pow{e}")
    assert [n.op for n in prog.nodes] == ["load", "powg"]
    x = _grid()
    got = prog.evaluate(torch.from_numpy(x)).numpy()
    with np.errstate(all="ignore"):
        # the exponent as the plugin's f32 constant
        want = np.power(x.astype(np.float64),
                        np.float64(np.float32(e))).astype(np.float32)
    assert _ulps(got, want).max() <= 1


def test_tensor_exponent_against_numpy_float64():
    x = _grid(1000, seed=3)
    y = np.random.default_rng(4).permutation(x)
    ys = np.array([0.0, -0.0, 1.5, -1.5, 2.0, 3.0, -3.0, np.inf, -np.inf,
                   np.nan, 1e10, -1e10, 4.0, -2.0, 1.0], np.float32)
    y[: 4 * ys.size] = np.tile(ys, 4)
    with np.errstate(all="ignore"):
        want = np.power(x.astype(np.float64),
                        y.astype(np.float64)).astype(np.float32)
    assert _ulps(rf_math.pow_(x, y), want).max() <= 1
    for fn, base in ((lambda l: 2 ** l, 2.0), (lambda l: l ** l, None)):
        prog = rc.trace(fn, "tensor_exponent")
        assert [n.op for n in prog.nodes] == ["load", "powg"]
        got = prog.evaluate(torch.from_numpy(x)).numpy()
        with np.errstate(all="ignore"):
            ref = np.power(np.float64(base) if base else x.astype(np.float64),
                           x.astype(np.float64)).astype(np.float32)
        assert _ulps(got, ref).max() <= 1


@pytest.mark.parametrize("op", sorted(OPS) + ["pow"])
def test_against_jnp_within_stated_ulps(op):
    import jax
    import jax.numpy as jnp

    x = _grid()
    if op == "pow":
        worst = 0
        for e in EXPONENTS:
            want = np.asarray(jax.jit(lambda v: jnp.power(v, e))(x))
            got = rf_math.pow_(x, np.float32(e))
            d = np.where(_normal(x, got, want), _ulps(got, want), 0)
            worst = max(worst, int(d.max()))
        want = np.asarray(jax.jit(lambda v: jnp.power(v, v))(x[:3000]))
        got = rf_math.pow_(x[:3000], x[:3000])
        d = np.where(_normal(x[:3000], got, want), _ulps(got, want), 0)
        worst = max(worst, int(d.max()))
    else:
        jfn = (jax.nn.sigmoid if op == "sigmoid"
               else getattr(jnp, OPS[op][2]))
        want = np.asarray(jax.jit(jfn)(x))
        got = rf_math.UNARY[op](x)
        worst = int(np.where(_normal(x, got, want), _ulps(got, want),
                             0).max())
    assert worst <= JNP_ULPS[op], (op, worst)


def test_rounding_ops_exact_and_not_graph_ops():
    fn = lambda l: (torch.floor(l) + l.ceil() + torch.trunc(l)
                    + torch.round(l) + torch.fix(l) + l.abs())
    prog = rc.trace(fn, "rounding")
    assert not prog.uses_graph
    x = torch.from_numpy(_grid())
    got, want = prog.evaluate(x).numpy(), fn(x).numpy()
    assert (_ulps(got, want) == 0).all()
    with pytest.raises(rc.UnsupportedResourceFunction, match="decimals"):
        rc.trace(lambda l: torch.round(l, decimals=1), "decimals")


@pytest.mark.parametrize("op", sorted(OPS) + ["powg", "tensor_exponent"])
def test_plain_form_routes_new_ops_through_the_graph(op):
    fn = {"powg": lambda l: torch.where(l > 1.0, l ** 1.5, l),
          "tensor_exponent": lambda l: 2 ** l}.get(op) or OPS[op][0]
    form = rc.plain_form(fn)
    assert isinstance(form, rc.ResourceProgram) and form.fn is fn
    ids, header = rc.kernel_plan([fn])
    assert ids == [rc.PLUGIN_BASE]
    name = "rf_pow" if op in ("powg", "tensor_exponent") else f"rf_{op}"
    assert f"{name}(" in header


# -------------------------------------------------- the header and build
def test_header_constants_equal_the_plain_version():
    text = (PKG / "csrc" / "rf_math.cuh").read_text()
    defs = {m.group(1): float.fromhex(m.group(2)) if "0x" in m.group(2)
            else float(m.group(2)) for m in re.finditer(
                r"#define RFM_(\w+) (-?[0-9a-fx.p+-]+)", text)}
    for name in ("LN2", "LN2_HI", "LN2_LO", "INV_LN2", "INV_LN10",
                 "LOG10_2", "SQRT2", "EXP_LIMIT", "EXP2_LIMIT", "TANH_ONE",
                 "LOG1P_LO", "LOG1P_HI"):
        assert defs[name] == getattr(rf_math, name), name

    def horner(fn_name):
        body = text[text.index(f"double {fn_name}("):]
        body = body[: body.index("\n}")]
        return [float.fromhex(h) for h in
                re.findall(r"(0x1\.[0-9a-f]+p[+-]\d+)", body)]
    # the header writes each polynomial from its last coefficient down
    assert horner("rfm_em1_poly") == list(rf_math.EM1)[::-1]
    assert horner("rfm_log1p_core") == list(rf_math.ATANH)[::-1]


def test_generated_header_stable_and_digest_follows_rf_math(tmp_path):
    case = cases.with_plugins(cases.abilene_case(batch=1, intervals=1),
                              cases.MATH_PLUGINS)
    ids, header = rc.kernel_plan(case.engine.tables.resource_fns)
    ids2, header2 = rc.kernel_plan(case.engine.tables.resource_fns)
    assert ids == ids2 == [2, 3, 4] and header == header2
    for fn in ("rf_tanh(", "rf_log1p(", "rf_pow("):
        assert fn in header
    src = PKG / "csrc" / "substep_megakernel.cu"
    assert '#include "rf_math.cuh"' in src.read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(src.parent, copy)
    flags = tuple(NVCC_FLAGS) + ("-fmad=false", "-DSUBSTEP_RF_PLUGINS")
    gen = {rc.HEADER_NAME: header}
    before = library_digest(copy / src.name, flags, gen)
    assert before == library_digest(src, flags, gen)
    math_h = copy / "rf_math.cuh"
    math_h.write_text(math_h.read_text().replace("#define RFM_TANH_ONE 20.0",
                                                 "#define RFM_TANH_ONE 21.0"))
    assert library_digest(copy / src.name, flags, gen) != before


# --------------------------------------------- the engines under plugins
def _tanh_j(load):
    import jax.numpy as jnp
    return 2.0 * jnp.tanh(load / 2.0)


def _log1p_j(load):
    import jax.numpy as jnp
    return jnp.where(load > 0.0, jnp.log1p(load) + 0.1 * load,
                     jnp.zeros_like(load))


def _pow15_j(load):
    import jax.numpy as jnp
    return jnp.where(load > 1.0, load ** 1.5, load)


JAX_TWINS = {"case_tanh": _tanh_j, "case_log1p": _log1p_j,
             "case_pow15": _pow15_j}


def _register_jax():
    from gsc_tpu.config.registry import register_resource_function as j_reg

    assert set(JAX_TWINS) == set(cases.MATH_PLUGINS)
    for name, fn in JAX_TWINS.items():
        j_reg(name)(fn)


@pytest.mark.parametrize("batch", [1, 4])
def test_plain_engine_matches_jax_under_math_plugins(batch):
    from test_torch_substep import _run_both

    _register_jax()
    case = cases.with_plugins(cases.abilene_case(batch=batch, intervals=2),
                              cases.MATH_PLUGINS)
    fns = case.engine.tables.resource_fns
    assert all(isinstance(f, rc.ResourceProgram) for f in fns)
    tstate = _run_both(case)
    base = cases.run_case(cases.abilene_case(batch=batch, intervals=2),
                          "cpu")[-1]
    # the plugins changed what the replicas admitted
    assert not torch.equal(tstate.metrics.drop_reasons,
                           base.metrics.drop_reasons)


def test_per_flow_control_matches_jax_under_math_plugins():
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
    cases.register_plugins()
    # arrivals every 1 ms on average (test_torch_resource_plugins.py's
    # twin: 2 ms), so that these demands, below the quadratic's, still
    # overflow the line's node capacity of 10 and admission is exercised
    p = Pair(controller="per_flow", inter_arrival_mean=1.0)

    def svc(S, F):
        return S(sfc_list={"sfc_1": ("a", "b", "c")}, sf_list={
            n: F(name=n, processing_delay_mean=5.0,
                 processing_delay_stdev=0.0, resource_function_id=rf)
            for n, rf in zip("abc", tuple(cases.MATH_PLUGINS))})

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


def test_every_new_op_gets_a_kernel_plan():
    from gsc_tpu_torch.ops.substep import resource_plan

    fns = {"rf_all_exp": lambda l: torch.exp(-l) + l.expm1() + 2 ** l,
           "rf_all_log": lambda l: torch.log1p(torch.relu(l)) + torch.log(
               l.abs() + 1) + l.abs().log2() - torch.log10(l * l + 1),
           "rf_all_sat": lambda l: torch.tanh(l) + torch.sigmoid(l)
           + torch.floor(l) + l.ceil() + l ** 2.5 + l ** l}
    for name, fn in fns.items():
        registry.register_resource_function(name)(fn)
    case = cases.with_plugins(cases.battery_case("node_cap"), tuple(fns))
    tabs = resource_plan(case.engine, "cpu")
    assert tabs["rf_id"].tolist()[:3] == [2, 3, 4]
    assert cases.run_case(case, "cpu")[-1].t.item() > 0


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_header_functions_bit_equal_on_the_card():
    dev = _card()
    x = _grid(20000, seed=5)
    y = np.where(np.random.default_rng(6).random(x.size) < 0.5,
                 np.random.default_rng(7).choice(np.array(
                     [0.0, -0.0, 1.5, -1.5, 2.0, 3.0, -3.0, np.inf, -np.inf,
                      np.nan, 0.3, 1e10], np.float32), x.size),
                 np.random.default_rng(8).permutation(x)).astype(np.float32)
    got = card_values(torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev)).cpu().numpy()
    want = rf_math.plain_values(x, y)
    for j, name in enumerate(rf_math.PROBE_ORDER):
        assert (_ulps(got[:, j], want[:, j]) == 0).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node_cap", "abilene_b4", "perflow"])
def test_math_plugin_kernel_bit_equal_to_plain(name):
    from gsc_tpu_torch.ops.substep import substep_megakernel

    dev = _card()
    if name == "perflow":
        case = cases.with_plugins(cases.perflow_random_case(
            batch=8, substeps=120), cases.MATH_PLUGINS)
        got = cases.run_perflow_case(case, dev)
        want = cases.run_perflow_case(case, "cpu", plain=True)
    else:
        case = cases.with_plugins(
            cases.battery_case(name) if name == "node_cap"
            else cases.abilene_case(batch=4, intervals=2),
            cases.MATH_PLUGINS)
        before = substep_megakernel.plugin_launches
        got = cases.run_case(case, dev)
        assert substep_megakernel.plugin_launches - before == case.intervals
        want = cases.run_case(case, "cpu", plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert cases.bit_equal(g.to("cpu"), w), f"{name} record {i}"
