// Native traffic pre-generation: the host-side hot path.
//
// Every episode, every env replica needs a freshly sampled traffic
// schedule (arrival times, rates, sizes, TTLs, SFC and egress choices per
// ingress node).  The numpy path of gsc_tpu_torch/sim/traffic.py is a
// per-flow Python loop; at bench scale (hundreds of replicas x thousands
// of flows per episode) that loop is minutes of host time per training
// run.  This file generates the same schedule layout in microseconds and
// is loaded with ctypes (gsc_tpu_torch/native/__init__.py).  It is the
// port's copy of the JAX package's sampler, byte for byte in what it
// computes: one seed gives the same flows in both packages.
//
// Semantics (the numpy path's structure; each path is reproducible from
// its seed, but the two paths draw in different orders):
//  - per-(interval, ingress) arrival means, NaN = ingress inactive; an
//    inactive ingress skips forward to its next active interval
//  - flow generated first, then the inter-arrival sleep
//  - deterministic or exponential inter-arrival
//  - dr ~ Normal(mean, stdev); size = shape (det) or Pareto(shape)+1;
//    joint rejection-resample of negatives
//  - duration = size / dr * 1000 ms
//  - TTL/SFC/egress uniform choices
//  - records sorted by arrival time; at most `capacity` kept
//
// Build: g++ -O2 -shared -fPIC -o traffic_gen.so traffic_gen.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// returns number of flows written (<= capacity)
int gsc_generate_flows(
    uint64_t seed,
    int episode_steps, double run_duration,
    int n_nodes, const double* means,  // [episode_steps * n_nodes]
    double dr_mean, double dr_stdev,
    double size_shape, int det_arrival, int det_size,
    const double* ttl_choices, int n_ttl,
    int n_sfcs,
    const int* egress_nodes, int n_egress,
    int capacity,
    double* out_times, int* out_ingress, double* out_drs, double* out_durs,
    double* out_ttls, int* out_sfcs, int* out_egs) {
  std::mt19937_64 rng(seed);
  std::normal_distribution<double> dr_dist(dr_mean, dr_stdev);
  std::exponential_distribution<double> unit_exp(1.0);
  std::uniform_real_distribution<double> unif(0.0, 1.0);

  const double horizon = episode_steps * run_duration;
  std::vector<double> times;
  std::vector<int> ingress;
  std::vector<double> drs, durs, ttls;
  std::vector<int> sfcs, egs;

  for (int node = 0; node < n_nodes; ++node) {
    // only nodes with any active interval generate (ingress marking is
    // encoded by non-NaN means)
    double t = 0.0;
    while (t < horizon) {
      int k = static_cast<int>(t / run_duration);
      if (k >= episode_steps) break;
      double mean = means[k * n_nodes + node];
      if (std::isnan(mean)) {
        // deactivated: jump to the next active interval, if any
        int nxt = -1;
        for (int j = k + 1; j < episode_steps; ++j) {
          if (!std::isnan(means[j * n_nodes + node])) { nxt = j; break; }
        }
        if (nxt < 0) break;
        t = nxt * run_duration;
        continue;
      }
      // joint rejection-resample of (dr, size)
      double dr, size;
      for (;;) {
        dr = dr_stdev > 0.0 ? dr_dist(rng) : dr_mean;
        if (det_size) {
          size = size_shape;
        } else {
          // Pareto(shape)+1 via inverse CDF, matching numpy's
          // rng.pareto(a) = (1-u)^(-1/a) - 1, then +1
          double u = unif(rng);
          size = std::pow(1.0 - u, -1.0 / size_shape);  // pareto + 1
        }
        if (dr >= 0.0 && size >= 0.0) break;
      }
      times.push_back(t);
      ingress.push_back(node);
      drs.push_back(dr);
      durs.push_back(dr > 0.0 ? size / dr * 1000.0 : 0.0);
      ttls.push_back(ttl_choices[static_cast<int>(unif(rng) * n_ttl) % n_ttl]);
      sfcs.push_back(static_cast<int>(unif(rng) * n_sfcs) % n_sfcs);
      egs.push_back(n_egress > 0
                        ? egress_nodes[static_cast<int>(unif(rng) * n_egress)
                                       % n_egress]
                        : -1);
      t += det_arrival ? mean : mean * unit_exp(rng);
    }
  }

  // stable sort by arrival time
  std::vector<int> order(times.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return times[a] < times[b]; });

  int n = static_cast<int>(std::min<size_t>(order.size(), capacity));
  for (int i = 0; i < n; ++i) {
    int j = order[i];
    out_times[i] = times[j];
    out_ingress[i] = ingress[j];
    out_drs[i] = drs[j];
    out_durs[i] = durs[j];
    out_ttls[i] = ttls[j];
    out_sfcs[i] = sfcs[j];
    out_egs[i] = egs[j];
  }
  return n;
}

}  // extern "C"
