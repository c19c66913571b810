"""The port's serving slice end to end on the CPU: ``run_serve`` of an
actor drawn from the seed at a small width (hidden 8, actor (16,))
through the deadline micro-batcher and
buckets 1/4/8.  Answers must equal direct ``greedy_action`` calls on the
same pool observation (tolerance below), every destination row must sum to
1, and padded batch rows must not change the real rows (exact: rows never
interact).

Tolerance for answers against unbatched calls: rtol 1e-6, atol 1e-7 — the
CPU matmuls may block a batch of 8 rows differently from a batch of 1.
"""
import numpy as np
import pytest
import torch

from gsc_tpu_torch.config import init_configs_agent
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.serve import run_serve
from gsc_tpu_torch.serve.policy import GreedyServePolicy
from torch_port_helpers import one_torch_thread  # noqa: F401

AGENT = dict(gnn_impl="pallas", gnn_features=8, actor_hidden_layer_nodes=(16,))


@pytest.fixture(scope="module")
def report():
    return run_serve(agent=init_configs_agent(**AGENT), device="cpu",
                     pool_steps=3, requests=24, concurrency=4,
                     seeded_actor=True)


def _single(ddpg, obs):
    batch = GraphObs(**{k: torch.from_numpy(np.asarray(v))[None]
                        for k, v in vars(obs).items()})
    return ddpg.greedy_action(batch)[0].numpy()


def test_run_serve_answers_every_request(report):
    s = report.summary()
    assert s["completed"] == 24 and s["errors"] == 0
    assert s["device"] == "cpu"
    assert s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]
    assert sum(n for n, _ in report.flushes) == 24
    assert all(b in (1, 4, 8) and 0 < n <= b for n, b in report.flushes)
    for k, ans in report.answers:
        assert ans.shape == (1728,) and np.isfinite(ans).all()
        np.testing.assert_allclose(ans.reshape(-1, 24).sum(-1), 1.0,
                                   rtol=1e-5)


def test_answers_equal_unbatched_greedy_calls(report):
    for k, ans in report.answers:
        np.testing.assert_allclose(ans, _single(report.ddpg, report.pool[k]),
                                   rtol=1e-6, atol=1e-7)


def test_padding_rows_do_not_change_real_rows(report):
    policy = GreedyServePolicy(report.ddpg, report.pool[0])
    t = policy.template
    reqs = [t.flatten(o) for o in report.pool[:4]]
    full = policy.run_batch(t.stack_pad(reqs, 8))
    for k in range(1, 4):
        padded = policy.run_batch(t.stack_pad(reqs[:k], 8))
        np.testing.assert_array_equal(padded[:k], full[:k])


def test_run_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_serve(agent=init_configs_agent(**AGENT), requests=1)


def test_cli_serve_on_cpu(capsys):
    """``python -m gsc_tpu_torch.cli serve`` at the flagship widths, built
    from the init-configs values in code."""
    import json

    from gsc_tpu_torch.cli import main

    assert main(["serve", "--device", "cpu", "--requests", "3",
                 "--concurrency", "2", "--pool-steps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["completed"] == 3 and out["errors"] == 0
    assert out["device"] == "cpu" and out["p99_ms"] > 0
