"""The substep megakernel's wrapper and the attention kernel's gradient,
without JAX.

This file imports torch and the port only, so it runs on the card, where
JAX is absent (``python -m pytest --noconftest
tests/test_torch_substep_kernel.py -q``); every test is marked ``cuda``
and skips without a card (the wrapper's CPU behaviour is tested in
tests/test_torch_substep.py).  On the card the kernel is held against its
plain version (bit for bit on CPU copies of the inputs, with its count of
admission rounds that took the sequential scan above 0 only on the
wide-range case; the generalization path's mixed batch, link and node
faults and factory draws among them), its stage-clocked build against
the kernel, the
attention kernel's gradients through its ``autograd.Function`` against
the dense path's, and the wrapper must refuse CPU inputs and a resource
function that the kernel does not compile in.

Tolerances: megakernel state bit-equal to the plain version on CPU copies
(the kernel keeps the CPU version's float order, or a scan order that is
exact in a double; these cases' whole-slot sums, which PyTorch's CPU sum
vectorises, are exact or have at most two fractional terms); integer and boolean state exact and float state rtol
1e-5, atol 1e-5 against the plain version on the card (whose
scatter-adds are float atomics and whose cumsum is a parallel f32 scan,
so it adds in another order).  Attention gradients rtol
1e-4, atol 1e-5: the backward is the same dense VJP on both paths, and
the kernel's forward output differs from the dense one by f32 rounding
(the forward's tolerance is atol 1e-5), which the VJP does not amplify
beyond these bounds.
"""
import numpy as np
import pytest
import torch

from gsc_tpu_torch.config.schema import (EnvLimits, ServiceConfig,
                                         ServiceFunction, SimConfig)
from gsc_tpu_torch.config.registry import register_resource_function
from gsc_tpu_torch.ops.gat_attention import attention_plain, gat_attention
from gsc_tpu_torch.ops.substep import (STAGES, SubstepMegakernel,
                                       substep_megakernel)
from gsc_tpu_torch.sim import cases
from gsc_tpu_torch.sim.engine import SimEngine
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the battery cases of the parallel design's own paths: a span no double
# holds (sequential scans), 32 warps, a partial last warp
NEW_CASES = {
    "wide_range_dr": cases.wide_range_case,
    "abilene_b4_m1024": lambda: cases.abilene_case(
        batch=4, max_flows=1024, inter_arrival_mean=1.0),
    "abilene_b2_m200": lambda: cases.abilene_case(
        batch=2, max_flows=200, inter_arrival_mean=1.0),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_megakernel_matches_plain_on_card():
    dev = _card()
    for case in (cases.battery_case("stochastic_startup"), cases.wrr_case(),
                 cases.fractional_case()):
        before = substep_megakernel.launches
        got = cases.run_case(case, dev)
        assert substep_megakernel.launches == before + case.intervals
        want_gpu = cases.run_case(case, dev, plain=True)
        want_cpu = cases.run_case(case, "cpu", plain=True)
        for i, g in enumerate(got):
            cases.compare_states(g, want_gpu[i], RTOL, ATOL,
                                 f"{case.name}[{i}] vs plain on card: ")
            cases.compare_states(g, want_cpu[i], RTOL, ATOL,
                                 f"{case.name}[{i}] vs plain on CPU: ")
            assert cases.bit_equal(g.to("cpu"), want_cpu[i])
        again = cases.run_case(case, dev)
        assert cases.bit_equal(again[-1], got[-1])


# the generalization path's inputs: per-replica topologies, per-interval
# edge capacities, zeroed links and nodes, shaped and factory traffic
GENERALIZATION_CASES = {
    "mixed_topology": cases.mixed_topology_case,
    "link_fault": cases.link_fault_case,
    "node_fault": cases.node_fault_case,
    "factory": cases.factory_case,
}


@pytest.mark.parametrize("name", sorted(GENERALIZATION_CASES))
def test_kernel_arguments_of_generalization_cases(name):
    """The kernel's argument struct, built over CPU tensors: one stride
    per table group, shared tables made per replica where another table
    of their group is (a link-fault row of edge capacities beside shared
    delays), the interval's edge-capacity row in place of the
    topology's."""
    case = GENERALIZATION_CASES[name]()
    b, eng = case.batch, case.engine
    traffic = case.traffic.expand(b)
    state, cap = eng.begin_interval(eng.init(b, "cpu"), traffic,
                                    case.schedule, case.placement)
    state = state.replace(run_idx=state.run_idx + 2)
    topo = eng.interval_topology(state, case.topo.expand(b), traffic)
    args, _ = substep_megakernel._prepare(
        eng, state, topo, traffic, cap, case.noise(0), None,
        torch.zeros(1, dtype=torch.int64), None)
    per_replica = case.topo.node_cap.dim() == 2
    assert args.topo_nn_stride == (eng.N * eng.N if per_replica else 0)
    edge_table = case.traffic.edge_cap_t is not None
    assert args.topo_e_stride == (eng.E if per_replica or edge_table
                                  else 0)
    assert args.traf_stride == case.traffic.capacity
    if edge_table:
        assert torch.equal(topo.edge_cap, case.traffic.edge_cap_t[:, 2])
        assert (topo.edge_cap == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GENERALIZATION_CASES))
def test_megakernel_generalization_cases_bit_equal_on_card(name):
    """Kernel #2 on the generalization cases: one launch per interval,
    bit-equal to its plain version on CPU copies, no sequential scan,
    relaunch bit-identical."""
    dev = _card()
    case = GENERALIZATION_CASES[name]()
    assert case.name == name
    substep_megakernel.serial_rounds = 0
    before = substep_megakernel.launches
    got = cases.run_case(case, dev)
    assert substep_megakernel.launches == before + case.intervals
    assert substep_megakernel.serial_rounds == 0
    want_cpu = cases.run_case(case, "cpu", plain=True)
    for g, w in zip(got, want_cpu):
        assert cases.bit_equal(g.to("cpu"), w)
    again = cases.run_case(case, dev)
    assert cases.bit_equal(again[-1], got[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_CASES))
def test_megakernel_parallel_paths_bit_equal_on_card(name):
    dev = _card()
    case = NEW_CASES[name]()
    assert case.name == name
    substep_megakernel.serial_rounds = 0
    got = cases.run_case(case, dev)
    serial = substep_megakernel.serial_rounds
    if name == "wide_range_dr":
        assert serial > 0
    else:
        assert serial == 0
    want_cpu = cases.run_case(case, "cpu", plain=True)
    for g, w in zip(got, want_cpu):
        assert cases.bit_equal(g.to("cpu"), w)
    again = cases.run_case(case, dev)
    assert cases.bit_equal(again[-1], got[-1])


@pytest.mark.cuda
def test_stage_clocks_build_matches_the_kernel():
    """The clocked build gives the kernel's interval bit for bit and a
    positive cycle count for every stage of every replica."""
    dev = _card()
    case = cases.fractional_case()
    eng, b = case.engine, case.batch
    traffic = case.traffic.to(dev)
    state, cap = eng.begin_interval(eng.init(b, dev), traffic,
                                    case.schedule.to(dev),
                                    case.placement.to(dev))
    z = case.noise(0)
    args = (eng, state, case.topo.to(dev).expand(b), traffic, cap,
            None if z is None else z.to(dev))
    clocked = SubstepMegakernel(stage_clocks=True)
    got = clocked.launch(*args)
    assert cases.bit_equal(got, substep_megakernel.launch(*args))
    assert clocked.stage_clocks.shape == (b, len(STAGES))
    assert bool((clocked.stage_clocks > 0).all())
    assert substep_megakernel.stage_clocks is None


@pytest.mark.cuda
def test_megakernel_refuses_cpu_pointers():
    """A state on the CPU, or one CPU input beside a state on the card, is
    refused before anything launches."""
    dev = _card()
    case = cases.battery_case("node_cap")
    eng = case.engine
    before = substep_megakernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        substep_megakernel.launch(eng, eng.init(1, "cpu"), case.topo,
                                  case.traffic, torch.ones(1, 8))
    with pytest.raises(ValueError, match="cpu"):
        substep_megakernel.launch(eng, eng.init(1, dev), case.topo.to(dev),
                                  case.traffic.to(dev), torch.ones(1, 8))
    assert substep_megakernel.launches == before


@pytest.mark.cuda
def test_megakernel_refuses_unknown_resource_function():
    dev = _card()
    # a plugin the kernel cannot compile: it does not trace (Python
    # control flow on a tensor's value; ``torch.exp(x)`` runs compiled in
    # since the double forms of csrc/rf_math.cuh)
    register_resource_function("card_test_branch")(
        lambda x: x if x.sum() > 0 else -x)
    sf = lambda n, rf="default": ServiceFunction(
        name=n, processing_delay_mean=5.0, processing_delay_stdev=0.0,
        resource_function_id=rf)
    svc = ServiceConfig(sfc_list={"sfc_1": ("a", "b")},
                        sf_list={"a": sf("a"), "b": sf("b",
                                                       "card_test_branch")})
    lim = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=2)
    engine = SimEngine(svc, SimConfig(), lim)
    case = cases.battery_case("node_cap")
    state = engine.init(1, dev)
    with pytest.raises(ValueError,
                       match="resource function 'card_test_branch': code "
                             "that does not trace"):
        substep_megakernel.launch(engine, state, case.topo.to(dev),
                                  case.traffic.to(dev),
                                  torch.ones(1, 8, device=dev))


@pytest.mark.cuda
def test_attention_gradients_through_the_kernel_match_dense():
    dev = _card()
    rng = np.random.default_rng(3)
    b, n, f = 8, 24, 22
    xl = torch.tensor(rng.normal(size=(b, n, f)), dtype=torch.float32,
                      device=dev, requires_grad=True)
    xr = torch.tensor(rng.normal(size=(b, n, f)), dtype=torch.float32,
                      device=dev, requires_grad=True)
    att = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev,
                       requires_grad=True)
    bias = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev,
                        requires_grad=True)
    adj = torch.tensor(rng.uniform(size=(b, n, n)) < 0.3, device=dev)
    adj[:, :, :] |= torch.eye(n, dtype=torch.bool, device=dev)
    adj[:, :2, :] = False
    g_out = torch.tensor(rng.normal(size=(b, n, f)), dtype=torch.float32,
                         device=dev)
    grads = []
    for fn in (gat_attention, attention_plain):
        for mean in (True,):
            out = fn(xl, xr, att, bias, adj, mean)
            grads.append(torch.autograd.grad(out, (xl, xr, att, bias),
                                             g_out))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
