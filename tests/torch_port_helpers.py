"""Shared fixture and stubs of the PyTorch-port tests
(tests/test_torch_*.py)."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run each port test module on one torch thread: the suite runs
    several pytest workers side by side, and the port's small-tensor ops
    gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_traffic_path(monkeypatch):
    """Both packages' numpy traffic path (the plain path) for the rest of a
    test: the port's by ``GSC_TPU_NO_NATIVE=1``, which it reads at every
    call, and the JAX package's by stubbing its native entry, because its
    loader reads the variable only once per process."""
    import gsc_tpu.native

    monkeypatch.setenv("GSC_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(gsc_tpu.native, "generate_flows_native",
                        lambda **kw: None)


class ArrayTemplate:
    """The batcher's template contract for requests that are one numpy
    array each: stub backends of the serving tests need no ``GraphObs``."""

    def __init__(self, sample):
        sample = np.asarray(sample)
        self.leaves = [sample]
        self.leaf_shapes = (sample.shape,)
        self.leaf_dtypes = (str(sample.dtype),)

    def flatten(self, obs):
        arr = np.asarray(obs)
        if arr.shape != self.leaf_shapes[0] \
                or str(arr.dtype) != self.leaf_dtypes[0]:
            raise ValueError(f"request is {arr.shape}/{arr.dtype}")
        return [arr]

    def stack_pad(self, requests, batch):
        k = len(requests)
        if not 0 < k <= batch:
            raise ValueError(f"{k} requests into a bucket of {batch}")
        return [np.stack([requests[min(j, k - 1)][0] for j in range(batch)])]


class StubPolicy:
    """An SPR-tier stand-in for ``PolicyServer(fallback=...)``: a fixed
    answer per request, no device."""

    def __init__(self, answer=(0.0, 1.0), leaf_dim=3):
        self.action = np.asarray(answer, np.float32)
        self.template = ArrayTemplate(np.zeros(leaf_dim, np.float32))

    def run_batch(self, leaves, n_real, bucket):
        return np.tile(self.action[None, :], (bucket, 1))
