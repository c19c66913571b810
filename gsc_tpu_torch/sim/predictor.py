"""Traffic prediction: the analytic look-ahead and a learned GRU forecaster.

The port of ``gsc_tpu.sim.predictor``:

- ``predict_ingress_traffic``: per-node data-rate sum of the arrivals in a
  control interval, straight from the TrafficSchedule tensors, on their
  device (the env shows it in place of the observed ingress traffic when
  ``SimConfig.prediction`` is set);
- ``interval_traffic_series``: the per-interval ingress traffic of one
  schedule, numpy, the forecaster's training data;
- ``RNNTrafficPredictor``: a one-step forecaster over a per-interval
  traffic series with min-max scaling, a GRU and a dense head trained by
  Adam.  Its cell follows flax ``GRUCell``'s equations
  (r = σ(W_ir x + b_ir + W_hr h), z likewise, n = tanh(W_in x + b_in +
  r (W_hn h + b_hn)), h' = (1 - z) n + z h): ``torch.nn.GRU`` has two more
  hidden biases, on r and z, which stay zero (their gradients are
  masked).  ``utils.convert.gru_forecaster_from_jax`` carries a flax
  forecaster's parameters in.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import TrafficSchedule


def predict_ingress_traffic(traffic: TrafficSchedule, run_idx: torch.Tensor,
                            run_duration: float,
                            n_nodes: int) -> torch.Tensor:
    """[B, N] predicted ingress dr of control interval ``run_idx`` [B]:
    every flow arriving in [run_idx, run_idx + 1) x run_duration adds its
    dr at its ingress.  ``traffic`` is shared or carries the batch dim."""
    b = run_idx.shape[0]
    traffic = traffic.expand(b)
    t0 = run_idx.to(torch.float32)[:, None] * run_duration
    t1 = t0 + run_duration
    at = traffic.arr_time
    in_window = (at >= t0) & (at < t1) & torch.isfinite(at)
    idx = torch.where(in_window, traffic.arr_ingress, n_nodes).long()
    vals = torch.where(in_window, traffic.arr_dr,
                       torch.zeros((), device=at.device))
    out = torch.zeros(b, n_nodes + 1, device=at.device)
    return out.scatter_add(1, idx, vals)[:, :n_nodes]


def interval_traffic_series(traffic: TrafficSchedule, run_duration: float,
                            episode_steps: int, n_nodes: int) -> np.ndarray:
    """[T, N] per-interval ingress dr of one (unbatched) schedule."""
    host = lambda t: t.detach().cpu().numpy()
    times = host(traffic.arr_time)
    ing = host(traffic.arr_ingress)
    drs = host(traffic.arr_dr)
    fin = np.isfinite(times)
    out = np.zeros((episode_steps, n_nodes), np.float32)
    k = np.minimum((times[fin] / run_duration).astype(int), episode_steps - 1)
    np.add.at(out, (k, ing[fin]), drs[fin])
    return out


class GRUForecaster(torch.nn.Module):
    """[T, 1] series -> [T, 1] one-step-ahead predictions: a GRU from a
    zero state and a dense head on every hidden state."""

    def __init__(self, hidden: int = 16):
        super().__init__()
        self.hidden = hidden
        self.gru = torch.nn.GRU(1, hidden)
        self.head = torch.nn.Linear(hidden, 1)
        with torch.no_grad():
            self.gru.bias_hh_l0[:2 * hidden].zero_()
        # flax's cell has no hidden bias on r and z: hold them at zero
        mask = torch.ones(3 * hidden)
        mask[:2 * hidden] = 0.0
        self.gru.bias_hh_l0.register_hook(lambda g: g * mask)

    def forward(self, series: torch.Tensor) -> torch.Tensor:
        hs, _ = self.gru(series[:, None, :])       # [T, 1, H]
        return self.head(hs[:, 0])


class RNNTrafficPredictor:
    """One-step traffic forecaster: min-max scale the per-interval traffic
    series, train the GRU to predict the next value, query it on a
    history."""

    def __init__(self, hidden: int = 16, lr: float = 1e-2, seed: int = 0):
        self.hidden = hidden
        self.seed = seed
        self.lr = lr
        self.model = None
        self.lo = 0.0
        self.hi = 1.0

    def _scale(self, x):
        return (x - self.lo) / max(self.hi - self.lo, 1e-9)

    def _unscale(self, y):
        return y * max(self.hi - self.lo, 1e-9) + self.lo

    def fit(self, series: np.ndarray, epochs: int = 300) -> float:
        """Train on a 1-D per-interval traffic series (full-batch Adam);
        returns the last step's MSE in the scaled space."""
        series = np.asarray(series, np.float32)
        self.lo, self.hi = float(series.min()), float(series.max())
        s = torch.from_numpy(self._scale(series)[:, None])
        x, y = s[:-1], s[1:]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            model = GRUForecaster(self.hidden)
        opt = torch.optim.Adam(model.parameters(), lr=self.lr)
        loss = torch.tensor(float("inf"))
        for _ in range(epochs):
            opt.zero_grad()
            loss = torch.mean((model(x) - y) ** 2)
            loss.backward()
            opt.step()
        self.model = model
        return float(loss.detach())

    def predict(self, history: np.ndarray) -> float:
        """Next-interval traffic given the observed history."""
        if self.model is None:
            raise RuntimeError("fit() first")
        s = torch.from_numpy(self._scale(np.asarray(history,
                                                    np.float32))[:, None])
        with torch.no_grad():
            pred = self.model(s)
        return float(self._unscale(float(pred[-1, 0])))
