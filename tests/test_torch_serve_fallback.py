"""The port's SPR serving tier (``gsc_tpu_torch.serve.fallback``) against
the JAX package's: ``spr_schedule_action`` bit-equal on Abilene, claranet,
a network whose source node has no capacity (rule 2) and one whose only
capable node is unreachable from a source (rule 3, the ``INF_DELAY``
exclusion), plus the rules themselves, writable answer rows, and the
tier through ``PolicyServer``."""
import numpy as np
import pytest

from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import EnvLimits
from gsc_tpu_torch.obs import MetricsHub
from gsc_tpu_torch.serve import (PolicyServer, SPRFallbackPolicy,
                                 spr_schedule_action)
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from torch_port_helpers import StubPolicy, one_torch_thread  # noqa: F401

NO_CAP_SOURCE = dict(
    node_caps=[0.0, 0.0, 5.0, 10.0, 0.0],
    node_types=["Ingress", "Ingress", "Normal", "Normal", "Egress"],
    edges=[(0, 1, 100.0, 2.0), (1, 2, 100.0, 3.0), (0, 3, 100.0, 9.0),
           (3, 4, 100.0, 1.0)])
UNREACHABLE = dict(
    # {0, 1} hold no capacity and reach nothing capable; {2, 3} are capable
    node_caps=[0.0, 0.0, 10.0, 4.0, 0.0],
    node_types=["Ingress", "Normal", "Normal", "Ingress", "Ingress"],
    edges=[(0, 1, 100.0, 1.0), (2, 3, 100.0, 1.0), (3, 4, 100.0, 2.0)])
NETWORKS = {"abilene": (24, 37), "claranet": (24, 37),
            "no_cap_source": (8, 8), "unreachable": (8, 8)}


def _specs(name):
    from gsc_tpu.topology import compiler as jcomp
    from gsc_tpu.topology import synthetic as jsyn

    if name in ("abilene", "claranet"):
        return getattr(synthetic, name)(), getattr(jsyn, name)()
    fields = NO_CAP_SOURCE if name == "no_cap_source" else UNREACHABLE
    return NetworkSpec(**fields), jcomp.NetworkSpec(**fields)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_spr_schedule_action_bit_equal_to_jax(name):
    from gsc_tpu.config.catalog import abc_service as jabc
    from gsc_tpu.config.schema import EnvLimits as JLimits
    from gsc_tpu.serve.fallback import spr_schedule_action as jspr
    from gsc_tpu.topology.compiler import compile_topology as jcompile

    n, e = NETWORKS[name]
    spec, jspec = _specs(name)
    got = spr_schedule_action(
        compile_topology(spec, max_nodes=n, max_edges=e),
        EnvLimits.for_service(abc_service(), max_nodes=n, max_edges=e))
    want = jspr(jcompile(jspec, max_nodes=n, max_edges=e),
                JLimits.for_service(jabc(), max_nodes=n, max_edges=e))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["no_cap_source", "unreachable"])
def test_spr_rules(name):
    spec, _ = _specs(name)
    topo = compile_topology(spec, max_nodes=8, max_edges=8)
    limits = EnvLimits.for_service(abc_service(), max_nodes=8, max_edges=8)
    sched = spr_schedule_action(topo, limits).reshape(
        limits.scheduling_shape)
    cap = np.asarray(spec.node_caps + [0.0] * 3)
    dst = {}
    for src in range(8):
        row = sched[src]
        if src >= len(spec.node_caps):
            assert row.sum() == 0.0        # padded sources get nothing
            continue
        assert (row.sum(axis=-1) == 1.0).all()
        dst[src] = int(row[0, 0].argmax())
    if name == "no_cap_source":
        # 0 and 1 have no capacity: the nearest capable node by delay
        # (0 -> 1 -> 2 costs 5, 0 -> 3 costs 9), 2 and 3 keep their own
        assert dst == {0: 2, 1: 2, 2: 2, 3: 3, 4: 3}
    else:
        # 0 and 1 reach nothing capable: the weight stays put (rule 3)
        assert dst == {0: 0, 1: 1, 2: 2, 3: 3, 4: 3}
        assert cap[dst[4]] > 0


def test_fallback_rows_are_writable_copies():
    topo = compile_topology(synthetic.abilene(), max_nodes=24, max_edges=37)
    limits = EnvLimits.for_service(abc_service())
    policy = SPRFallbackPolicy.__new__(SPRFallbackPolicy)
    policy.action = spr_schedule_action(topo, limits)
    out = policy.run_batch(None, 3, 4)
    assert out.shape == (4, policy.action.size) and out.flags.writeable
    out[0, 0] = 7.0
    assert policy.action[0] != 7.0 and out[1, 0] != 7.0


def test_spr_tier_through_policy_server():
    hub = MetricsHub()
    stub = StubPolicy(answer=np.arange(5.0))
    srv = PolicyServer(fallback=stub, buckets=(1, 4), deadline_ms=2.0,
                       hub=hub).start()
    try:
        outs = [srv.submit_sync(np.zeros(3, np.float32), timeout=30)
                for _ in range(3)]
    finally:
        srv.close()
    for out in outs:
        np.testing.assert_array_equal(out, stub.action)
    assert srv.tier == "spr" and srv.startup["tier"] == "spr"
    assert srv.startup["buckets"] == {}       # nothing to warm
    assert hub.histogram_summary("serve_latency_ms")["count"] == 3
    with pytest.raises(ValueError, match="exactly one"):
        PolicyServer(fallback=stub, policy=object())
