// Simulator substep megakernel for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel gsc_tpu/ops/pallas_substep.py:530
// (substep_megakernel; kernel fn _megakernel :513, body _substep_body :86):
// one substep of the duration-controller flow simulator, applied in place
// to the whole per-replica simulator state.  Here one launch runs ALL the
// substeps of a control interval (``K``, 100 at dt = 1 ms, run 100 ms) for
// every replica: one CTA per replica, one thread per flow slot (M <= 1024),
// the substep loop inside the kernel.
//
// What it computes, stage by stage (the order of the plain version,
// gsc_tpu_torch/sim/engine.py SimEngine.substep):
//  1. capacity releases from row g mod H of the node/edge release rings;
//  2. HOP/PROC timers; finished processing advances the chain position,
//     finished hops arrive, continue or depart;
//  3. up to 8 due arrivals ranked into free slots (padded rows gated by
//     isfinite(arr_time); late spawns count as truncated arrivals);
//  4. decisions: TTL drops, egress routing and WRR over the schedule row
//     in ``R`` rank levels of same-cell collisions;
//  5. forwarding: whole-path TTL check, link admission over flows grouped
//     by (edge, slot);
//  6. processing: placement check, processing delay, node admission over
//     flows grouped by (node, slot) through the resource functions
//     ("default" = id 0, "overhead" = id 1, compiled in; a user's plugins
//     from id 2, below), startup wait, delayed release;
//  7. departures, the seven drop masks mapped to four reasons, counters.
//
// Per-flow control (the JAX package's XLA substep with ext_decisions,
// gsc_tpu/sim/engine.py:389,576-600; its Pallas kernel refuses it) is a
// mode of this kernel, two switches that the wrapper sets apart:
//  - ``ext_decisions`` [B, M] (launched with K = 1, since the policy runs
//    between substeps) replaces stage 4's WRR: a flow with a destination
//    >= 0 goes there (clamped to the nodes), one without stays parked in
//    DECIDE with its timer and node (stage 5 forwards the decided flows
//    and the egress-bound only); the decided flows' requested traffic is
//    added per cell in slot order as the WRR's is; then the first decided
//    slot of each (node, SF) cell places it if absent (place-on-decision:
//    the startup clock starts where the cell was not available, the idle
//    clock where it is new) and a barrier publishes s_placed before
//    forwarding checks the placement;
//  - ``gc`` removes, at the end of every substep, an instance without
//    load whose idle clock is older than ``vnf_timeout``; it rides on the
//    deferred idle-clock stamp (``settle_idle``: the start of the next
//    substep, or the end of the launch), so K chained launches of one
//    substep equal one launch of K substeps.
// A launch with either switch set runs the kPerFlow instantiation; the
// duration controller's compiles without them, so the switches cost it no
// registers (with them compiled in, an H100 ran its intervals ~4% slower).
//
// What bounds it on this card: neither bytes nor operations.  A substep
// touches a few tens of KB of one replica's state and does a few thousand
// operations, so the kernel is latency-bound by its chain of block-wide
// steps.  The design keeps that chain short and parallel:
//  - the flow table, the small per-replica tables (node load, SF
//    availability and activity, edge use, the run metrics the substep
//    updates, capacities, the service tables) and the scalar counters live
//    in shared memory for the whole interval; only the release rings, the
//    WRR schedule and counts, the path tables and the traffic stay in
//    device memory;
//  - every stage runs one thread per slot or per sorted position, with
//    at most 13 + R __syncthreads per substep (R = WRR rank levels in
//    use, 2 in place of them under per-flow decisions; 6 of the 13 are
//    the three admission rounds);
//  - lists of flagged slots (free, arrived, WRR, requesting, admitted,
//    departing) are warp ballots: ranks and counts are popcounts, and
//    loops over such a list visit only its set bits;
//  - arrivals: the r-th free slot takes the r-th due candidate itself;
//  - WRR: each warp chooses for its selected slots in turn, one lane per
//    destination;
//  - the sorted groups come from count-ranking: each thread counts the
//    keys below its own, which gives its sorted position and, from the
//    keys strictly below, the start of its key's run;
//  - the link and the node admission share their rounds: both prefix
//    sums are block-wide double scans (warp shuffles, skipped by a warp
//    without a value, then the warp totals in shared memory), and each
//    sorted position tests itself; a pipeline without requests skips its
//    rounds, and the rounds stop once a round admits what the last one
//    did (the next would repeat it);
//  - scatter-adds go by target: the first flagged slot of each target adds
//    that target's values in slot order, targets in parallel;
//  - shared memory holds 40 to 42 four-byte words per slot: arrays whose
//    lifetimes within a substep do not overlap share one region, and an
//    admission base is kept only in its pipeline's own column, so M = 1024
//    slots fit beside tables of N <= 256 nodes, P <= 5 SFs, C <= 2 chains
//    and E <= 384 edges (bench.py's interroute and rung-5 stacks) in one
//    CTA;
//  - what the per-slot results need after the admission rounds passes
//    through shared memory, not registers, and blocks of up to 256
//    threads (the flagship's 128 slots) run an instantiation without the
//    64-register cap that 1024-thread blocks impose.
//
// Exactness: integer results are order-free (int atomics, popcounts).
// Float sums keep the plain CPU version's order: scatter-adds in slot
// order per target, and the admission prefix sums as below.  The three
// whole-slot sums (path credit, processing delay, departures) run in slot
// order over the flagged slots, whose other entries are zeros that leave a
// sum unchanged, and the plain version adds them in slot order too
// (gsc_tpu_torch/sim/engine.py slot_order_sum), so the two agree bit for
// bit however many fractional terms meet in one substep.  Rounding half
// to even
// (__float2int_rn) where the plain version calls torch.round; -fmad=false,
// since an FMA would round a*b+c once where the plain version rounds
// twice.  No float atomics are used, so two launches on the same inputs
// give identical bits.  Out-of-range indices read as zero rows and
// scatter nowhere, as the plain version's gathers and scatters do.
//
// The admission prefix sums.  PyTorch's CPU cumsum adds an f32 column
// sequentially into a double and rounds each prefix to f32.  The kernel
// adds in a tree (a warp scan, then the warp totals) and is still
// bit-equal whenever every partial sum is exact in a double: let lo be
// the smallest exponent of a lowest set bit among the nonzero values, top
// the largest floor(log2|v|), n their count and hi = top + 1 +
// ceil(log2 n).  Every partial sum, in any association, is an integer
// multiple of 2^lo of magnitude below 2^hi; if hi - lo <= 53 a double
// holds each exactly, every addition is exact, and every order gives the
// exact prefix, rounded to the same f32.  Leaves start from +0.0 (a -0.0
// value enters as +0.0), as the sequential accumulator does.  lo, top and
// n come from integer block reductions (order-free), once per round and
// pipeline.  A round that fails the test, or holds a non-finite value,
// runs the sequential double scan on one thread instead (the exact
// algorithm for inputs whose order matters) and adds 1 to the count in
// ``serial_rounds``.  On this system's traffic (data rates ~N(1, 0.35),
// at most 1,024 positions) the span stays under 40 bits and no round goes
// serial.
//
// Resource-function plugins: a build with SUBSTEP_RF_PLUGINS includes
// "resource_plugins.cuh", which ops/resource_codegen.py generates from the
// plugins' traced graphs (``float rf_plugin(int id, float load)`` over ids
// 2 and up, every float operation rounded as the CPU's torch op rounds it).
// The wrapper builds one library per plugin set; without plugins the
// header is not included and the build is the kernel above.
//
// SUBSTEP_STAGE_CLOCKS builds (timing only, never the main path): thread 0
// adds clock64() deltas per stage into ``stage_clocks`` [B, N_STAGES]; a
// few extra __syncthreads split stages that otherwise share one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#define PH_FREE 0
#define PH_DECIDE 1
#define PH_HOP 2
#define PH_PROC 3
#define DROP_TTL 0
#define DROP_DECISION 1
#define DROP_LINK_CAP 2
#define DROP_NODE_CAP 3
#define EPS 1e-4f
#define ARRIVALS_PER_SUBSTEP 8
#define RF_DEFAULT 0
#define RF_OVERHEAD 1
#define RF_PLUGIN_BASE 2
#define MAX_THREADS 1024
#define MAX_WARPS (MAX_THREADS / 32)
// blocks of up to this many threads (M <= 256, the flagship's 128 slots)
// run an instantiation without the 64-register cap of 1024-thread blocks
#define SMALL_BLOCK 256
#define FULL_MASK 0xffffffffu
// bits of a double's significand: every integer multiple of 2^lo below
// 2^(lo + 53) is exact
#define DOUBLE_BITS 53

// Every field is 8 bytes, in this order, mirrored by ctypes in
// gsc_tpu_torch/ops/substep.py (checked through substep_args_size()).
struct SubstepArgs {
    long long B, M, N, C, S, P, E, H, F, K, R, iters;
    double dt;
    // per-replica element strides of the topology and traffic tables
    // (0 = one table shared by every replica)
    long long topo_nn_stride, topo_e_stride, traf_stride;
    // state [B, ...]
    float* t; int* cursor; int* truncated;
    int* phase; int* sfc; int* position; int* node; int* dest; int* hop_next;
    int* egress; float* dr; float* duration; float* ttl; float* e2e;
    float* pend_path; float* timer;
    float* node_load; uint8_t* sf_available; float* sf_startup;
    float* sf_last_active; uint8_t* placed; const float* schedule;
    float* edge_used; float* rel_node; float* rel_edge;
    // metrics [B, ...]
    int* generated; int* processed; int* dropped; int* active;
    int* drop_reasons; float* sum_proc_delay; int* num_proc_delay;
    float* sum_path_delay; int* num_path_delay; float* sum_e2e;
    int* run_generated; int* run_processed; int* run_dropped;
    int* run_dropped_per_node; float* run_e2e_sum; float* run_e2e_max;
    float* run_path_delay_sum; float* run_requested;
    float* run_requested_node; float* run_processed_traffic;
    int* run_flow_counts; float* run_max_node_usage;
    float* run_passed_traffic;
    // topology
    const float* path_delay; const int* next_hop; const int* adj_edge_id;
    const float* edge_cap; const float* edge_delay;
    // traffic
    const float* arr_time; const int* arr_ingress; const float* arr_dr;
    const float* arr_duration; const float* arr_ttl; const int* arr_sfc;
    const int* arr_egress;
    const float* cap_now;   // [B, N]
    const float* noise;     // [B, K, M] standard normals, or null
    // service tables
    const int* chain_len;   // [C]
    const int* chain_sf;    // [C * S]
    const float* proc;      // [P, 3] mean, stdev, startup delay
    const int* rf_id;       // [P]
    // [1] admission rounds that ran the sequential scan, added over
    // replicas (integer atomics)
    unsigned long long* serial_rounds;
    // [B, N_STAGES] clock64() cycles per stage; SUBSTEP_STAGE_CLOCKS
    // builds only, null otherwise
    long long* stage_clocks;
    // per-flow control: [B, M] destination node per slot (-1: none), in
    // place of the WRR, with place-on-decision (placed and sf_startup are
    // then written back); null under the duration controller (K = 1
    // otherwise, the wrapper's check)
    const int* ext_decisions;
    // nonzero: instances idle for longer than vnf_timeout ms are removed
    // at the end of every substep (per-flow control, with or without
    // ext_decisions; placed is then written back)
    long long gc;
    double vnf_timeout;
};

// stages of a substep, as the clocked build attributes them
enum { ST_RELEASE_TIMERS, ST_ARRIVALS, ST_DECISIONS, ST_WRR, ST_FORWARD,
       ST_GROUP, ST_SCAN, ST_TEST, ST_RESULTS, ST_RING_ADDS, ST_SCATTERS,
       N_STAGES };

// shared-memory int arrays of M entries: per slot (the flow table, then
// the forwarding's outcomes kept across the admission rounds), then per
// sorted position (_E: by (edge, slot), _N: by (node, slot))
enum { I_PH, I_SFC, I_POS, I_ND, I_DST, I_HN, I_EG, I_NH, I_FLAGS, I_ST_E,
       I_REQ_E, I_ADM_E, I_ST_N, I_SF_N, I_ND_N, I_WANT_N, I_ADM_N, N_IARR };
// float arrays of M entries: per slot, then per sorted position
enum { F_DR, F_DUR, F_TTL, F_E2E, F_PP, F_TMR, F_PDEL, F_PD, F_DR_E, F_HR_E,
       F_DR_N, F_CAP_N, F_DEM_N, N_FARR };
// One region of 4-byte arrays of M entries shared by three groups whose
// lifetimes within a substep do not overlap, each separated from the next
// by a block barrier: (1) the timers' path credits, read by the arrivals,
// and the decisions' cells, read by the WRR (U_PC and U_CELL never share
// an array: thread 0 may still add path credits while the others decide);
// (2) the admission rounds' values, prefix sums and bases, per sorted
// position (the node scan's prefix sums [M][P] from U_CS_N on; a node
// position's base differs from its prefix sums only in its own SF's
// column, so that column's base alone is kept, in U_BASE_N); (3) the
// slot results that the ring adds and the scatters read.  The region
// holds max(7, 5 + P) arrays.
enum { U_PC = 0, U_CELL = 1 };
enum { U_V_E = 0, U_CS_E, U_BASE_E, U_V_N, U_BASE_N, U_CS_N };
enum { U_TEDGE = 0, U_TRELE, U_TNODE, U_TRELN, U_PW, U_DEP, U_DEM,
       N_URES };
// per-replica tables: [NP] floats, [E] floats, [N] floats
enum { T_LOAD, T_LAST, T_STARTUP, T_PROCESSED, N_TNP };
enum { T_USED, T_ECAP, T_EDELAY, T_PASSED, N_TE };
enum { T_CAP, T_REQ_NODE, T_MAX_USE, N_TN };
// slot lists as warp ballots, one word per warp
enum { MK_FREE, MK_ARRIVED, MK_WRR, MK_REQ, MK_WANT, MK_ADM_E, MK_ADM_N,
       MK_DEP, N_MASKS };
// a slot's outcomes of the decisions and forwarding, kept in shared memory
// (I_FLAGS, with the delays and next hop) across the admission rounds
enum { FL_DROP_TTL0 = 1, FL_DROP_TTL_PATH = 2, FL_HOP_REQ = 4,
       FL_START_PATH = 8, FL_DEPART_STAY = 16, FL_DEPART_HOP = 32,
       FL_DROP_UNPLACED = 64, FL_WANT = 128, FL_DROP_TTL_PD = 256 };

// the replica's scalars, held in shared memory for the interval
struct Scalars {
    int cursor, truncated, generated, processed, dropped, active;
    int drop_reasons[4];
    int num_proc_delay, num_path_delay, run_generated, run_processed,
        run_dropped, serial;
    float sum_proc_delay, sum_path_delay, sum_e2e, run_e2e_sum,
        run_e2e_max, run_path_delay_sum;
    // due and late arrival candidates (bits 0..7)
    unsigned due, late;
    int cand_ing[ARRIVALS_PER_SUBSTEP], cand_sfc[ARRIVALS_PER_SUBSTEP],
        cand_eg[ARRIVALS_PER_SUBSTEP];
    float cand_dr[ARRIVALS_PER_SUBSTEP], cand_dur[ARRIVALS_PER_SUBSTEP],
        cand_ttl[ARRIVALS_PER_SUBSTEP];
    // this substep's dropped slots and drops per reason
    int sub_drops, sub_reasons[4];
    // admission spans [round parity][link, node][lo, top, n]
    int span[2][2][3];
    long long clk[N_STAGES];
};

// byte offsets of the shared-memory regions (host and device agree)
struct Layout {
    size_t wtot, sc, key, ia, fa, un, tnp, te, tn, tcs, chain, mask,
        total;
};

__host__ __device__ inline size_t round16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline Layout layout_for(long long M, long long N,
                                             long long C, long long S,
                                             long long P, long long E) {
    Layout l;
    size_t off = 0;
    l.wtot = off; off += round16(sizeof(double) * MAX_WARPS * (P + 1));
    l.sc = off; off += round16(sizeof(Scalars));
    l.key = off; off += round16(sizeof(int) * 2 * M);
    l.ia = off; off += round16(sizeof(int) * N_IARR * M);
    l.fa = off; off += round16(sizeof(float) * N_FARR * M);
    const long long un = U_CS_N + P > N_URES ? U_CS_N + P : N_URES;
    l.un = off; off += round16(sizeof(float) * un * M);
    l.tnp = off; off += round16(sizeof(float) * (N_TNP + 2) * N * P);
    l.te = off; off += round16(sizeof(float) * N_TE * E);
    l.tn = off; off += round16(sizeof(float) * (N_TN + 1) * N);
    l.tcs = off; off += round16(sizeof(float) * N * C * S);
    l.chain = off; off += round16(sizeof(int) * (C + C * S + 4 * P));
    l.mask = off; off += round16(sizeof(unsigned) * N_MASKS * MAX_WARPS);
    l.total = off;
    return l;
}

#ifdef SUBSTEP_RF_PLUGINS
#include "resource_plugins.cuh"
#endif

__device__ __forceinline__ float resource_fn(int id, float load) {
    if (id == RF_OVERHEAD)
        return load > 0.0f ? __fadd_rn(1.0f, __fmul_rn(1.2f, load)) : 0.0f;
#ifdef SUBSTEP_RF_PLUGINS
    if (id >= RF_PLUGIN_BASE) return rf_plugin(id, load);
#endif
    return load;
}

// float -> int32 the way the CPU converts (truncation, INT_MIN outside
// the range), so a corrupt hold time lands in the same ring row
__device__ __forceinline__ int f2i_cpu(float x) {
    if (!(x > -2147483904.0f && x < 2147483648.0f)) return INT_MIN;
    return (int)x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int ring_row(int ridx, float hold, float dt,
                                        int H) {
    int off = clampi(f2i_cpu(ceilf(__fdiv_rn(hold, dt))), 1, H - 1);
    int h = (ridx + off) % H;
    return h < 0 ? h + H : h;
}

// the SF id at a flow's chain position (0 for a padded position)
__device__ __forceinline__ int sf_at(const int* chain_sf, int sfc, int pos,
                                     int C, int S) {
    const int sf = chain_sf[clampi(sfc, 0, C - 1) * S + clampi(pos, 0, S - 1)];
    return sf < 0 ? 0 : sf;
}

// WRR over one schedule row, by the whole warp (lane j takes destinations
// j, j + 32, ...): the first destination of the largest scheduled share
// minus realised ratio, as a scan from j = 0 keeps it (the shares are never
// NaN, so the first-largest is a total order and any reduction order
// finds it); the integer total is order-free
__device__ __forceinline__ int wrr_choice(const int* flow_counts,
                                          const float* schedule, int cell,
                                          int ncs, int N) {
    const int lane = threadIdx.x & 31;
    const bool ok = cell >= 0 && cell < ncs;
    const int* row = flow_counts + (size_t)(ok ? cell : 0) * N;
    const float* prow = schedule + (size_t)(ok ? cell : 0) * N;
    int total = 0;
    for (int j = lane; j < N; j += 32) total += ok ? row[j] : 0;
    total = __reduce_add_sync(FULL_MASK, total);
    float best = 0.0f;
    int bj = INT_MAX;
    for (int j = lane; j < N; j += 32) {
        const int cntj = ok ? row[j] : 0;
        const float ratio = total > 0
            ? __fdiv_rn((float)cntj, (float)(total > 1 ? total : 1)) : 0.0f;
        const float p = ok ? __ldg(prow + j) : 0.0f;
        const float d = p > 0.0f ? p - ratio : -1.0f;
        if (bj == INT_MAX || d > best) { best = d; bj = j; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(FULL_MASK, best, o);
        const int oj = __shfl_xor_sync(FULL_MASK, bj, o);
        if (oj != INT_MAX && (bj == INT_MAX || od > best ||
                              (od == best && oj < bj))) {
            best = od; bj = oj;
        }
    }
    return bj;
}

// each warp's ballot of ``pred`` into mask[warp]; every thread calls it
__device__ __forceinline__ void store_ballot(unsigned* mask, bool pred) {
    const unsigned bits = __ballot_sync(FULL_MASK, pred);
    if ((threadIdx.x & 31) == 0) mask[threadIdx.x >> 5] = bits;
}

// the first set slot at or after ``from``, or INT_MAX
__device__ __forceinline__ int next_set(const unsigned* mask, int nw,
                                        int from) {
    int w = from >> 5;
    if (w >= nw) return INT_MAX;
    unsigned bits = mask[w] & (FULL_MASK << (from & 31));
    while (bits == 0) {
        if (++w >= nw) return INT_MAX;
        bits = mask[w];
    }
    return (w << 5) + __ffs(bits) - 1;
}

#define FOR_SET(j, mask, nw, from) \
    for (int j = next_set(mask, nw, from); j != INT_MAX; \
         j = next_set(mask, nw, j + 1))

__device__ __forceinline__ int count_all(const unsigned* mask, int nw) {
    int n = 0;
    for (int w = 0; w < nw; ++w) n += __popc(mask[w]);
    return n;
}

__device__ __forceinline__ int count_before(const unsigned* mask, int m) {
    int n = 0;
    for (int w = 0; w < (m >> 5); ++w) n += __popc(mask[w]);
    return n + __popc(mask[m >> 5] & ((1u << (m & 31)) - 1u));
}

// no flagged slot before m has target t
__device__ __forceinline__ bool first_of(const unsigned* mask, int nw,
                                         const int* tgt, int m, int t) {
    for (int j = next_set(mask, nw, 0); j < m; j = next_set(mask, nw, j + 1))
        if (tgt[j] == t) return false;
    return true;
}

// acc + val[j] over the flagged slots j >= m with target t, in slot order
__device__ __forceinline__ float add_run(float acc, const unsigned* mask,
                                         int nw, const int* tgt,
                                         const float* val, int m, int t) {
    FOR_SET(j, mask, nw, m)
        if (tgt[j] == t) acc = acc + val[j];
    return acc;
}

// lowest set bit's exponent and floor(log2|v|) of a nonzero f32; a
// non-finite value gives a span no double holds
__device__ __forceinline__ void f32_span(float v, int& lo, int& top) {
    const unsigned u = __float_as_uint(v) & 0x7fffffffu;
    const int e = (int)(u >> 23);
    const unsigned man = u & 0x7fffffu;
    if (e == 255) {
        lo = -100000; top = 100000;
    } else if (e == 0) {
        lo = -149 + __ffs(man) - 1;
        top = -149 + 31 - __clz(man);
    } else {
        lo = e - 150 + __ffs(man | 0x800000u) - 1;
        top = e - 127;
    }
}

// block-wide span of the nonzero values: warp reductions, then integer
// shared-memory atomics into span[lo, top, n]
__device__ __forceinline__ void reduce_span(int* span, float v) {
    int lo = INT_MAX, top = INT_MIN, nz = 0;
    if (v != 0.0f) { f32_span(v, lo, top); nz = 1; }
    lo = __reduce_min_sync(FULL_MASK, lo);
    top = __reduce_max_sync(FULL_MASK, top);
    nz = __reduce_add_sync(FULL_MASK, nz);
    if ((threadIdx.x & 31) == 0 && nz > 0) {
        atomicMin(&span[0], lo);
        atomicMax(&span[1], top);
        atomicAdd(&span[2], nz);
    }
}

// every association of the values' sums is exact in a double
__device__ __forceinline__ bool order_free(const int* span) {
    const int n = span[2];
    if (n == 0) return true;
    const int clog = n > 1 ? 32 - __clz(n - 1) : 0;
    return (long long)span[1] + 1 + clog - span[0] <= DOUBLE_BITS;
}

__device__ __forceinline__ void reset_span(int* span) {
    span[0] = INT_MAX; span[1] = INT_MIN; span[2] = 0;
}

__device__ __forceinline__ double warp_scan(double x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// the warp scan of f32 values, skipped (all +0.0) by a warp that holds
// no nonzero value
__device__ __forceinline__ double warp_scan_sparse(float v) {
    if (!__any_sync(FULL_MASK, v != 0.0f)) return 0.0;
    return warp_scan(v == 0.0f ? 0.0 : (double)v);
}

// inclusive block prefix from a warp-inclusive value and the warp totals
__device__ __forceinline__ double block_prefix(double x, const double* tot) {
    double pre = 0.0;
    for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) pre += tot[w];
    return pre + x;
}

// the end of a substep at time t for one (node, SF) cell of load x: an
// active cell's idle clock takes t (deferred to here: nothing reads it
// within a substep), and under gc an idle cell available for longer than
// vnf_timeout since its clock is removed (sf_last_active < t - vnf_timeout
// in f32, as the plain version compares)
__device__ __forceinline__ void settle_idle(int i, float x, float t, bool gc,
                                            float vnf_timeout, float* tnp,
                                            int NP, int* s_avail,
                                            int* s_placed) {
    float* last = tnp + (size_t)T_LAST * NP + i;
    if (x > EPS) {
        *last = t;
    } else if (gc && s_avail[i] && *last < __fsub_rn(t, vnf_timeout)) {
        s_avail[i] = 0;
        s_placed[i] = 0;
    }
}

#ifdef SUBSTEP_STAGE_CLOCKS
#define STAGE_MARK(s) do { if (tid == 0) { const long long now_ = clock64(); \
    sc.clk[s] += now_ - clk_last; clk_last = now_; } } while (0)
#define CLOCK_SPLIT(s) do { __syncthreads(); STAGE_MARK(s); } while (0)
#else
#define STAGE_MARK(s) do { } while (0)
#define CLOCK_SPLIT(s) do { } while (0)
#endif
#define STAGE_SYNC(s) do { __syncthreads(); STAGE_MARK(s); } while (0)

// kPerFlow: the instantiation that reads the two per-flow switches (the
// duration controller's, false, compiles none of their code)
template <int MAX_BLOCK, bool kPerFlow>
__global__ void __launch_bounds__(MAX_BLOCK)
substep_megakernel_kernel(SubstepArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const int nw = nth >> 5;
    const int M = (int)a.M, N = (int)a.N, C = (int)a.C, S = (int)a.S;
    const int P = (int)a.P, E = (int)a.E, H = (int)a.H, F = (int)a.F;
    const int K = (int)a.K, R = (int)a.R, ITERS = (int)a.iters;
    const int NP = N * P, NCS = N * C * S;
    const float dt = (float)a.dt;
    const bool own = tid < M;
    const int m = tid;
    const int* ext = (kPerFlow && a.ext_decisions != nullptr)
        ? a.ext_decisions + (size_t)b * M : nullptr;
    const bool gc = kPerFlow && a.gc != 0;
    const float vnf_timeout = (float)a.vnf_timeout;

    const Layout L = layout_for(M, N, C, S, P, E);
    Scalars& sc = *(Scalars*)(smem + L.sc);
    double* wtot = (double*)(smem + L.wtot);       // [P + 1][MAX_WARPS]
    int2* s_key = (int2*)(smem + L.key);            // (edge, node) keys
    int* si = (int*)(smem + L.ia);
    float* sf = (float*)(smem + L.fa);
    float* su = (float*)(smem + L.un);              // the shared region
    float* tnp = (float*)(smem + L.tnp);
    int* s_avail = (int*)(tnp + (size_t)N_TNP * NP);
    int* s_placed = s_avail + NP;
    float* te = (float*)(smem + L.te);
    float* tn = (float*)(smem + L.tn);
    int* s_dropnode = (int*)(tn + (size_t)N_TN * N);
    float* s_req_cell = (float*)(smem + L.tcs);    // run_requested [NCS]
    int* s_chain_len = (int*)(smem + L.chain);
    int* s_chain_sf = s_chain_len + C;
    float* s_proc = (float*)(s_chain_sf + C * S);
    int* s_rf = (int*)(s_proc + 3 * P);
    unsigned* masks = (unsigned*)(smem + L.mask);
#define SI(k) (si + (size_t)(k) * M)
#define SF(k) (sf + (size_t)(k) * M)
#define MASK(k) (masks + (k) * MAX_WARPS)
#define UF(k) (su + (size_t)(k) * M)
#define UI(k) ((int*)su + (size_t)(k) * M)
    float* s_csn = UF(U_CS_N);                      // [M, P] node scan
    int *s_ph = SI(I_PH), *s_sfc = SI(I_SFC), *s_pos = SI(I_POS),
        *s_nd = SI(I_ND), *s_dst = SI(I_DST), *s_hn = SI(I_HN),
        *s_eg = SI(I_EG);
    float *s_dr = SF(F_DR), *s_dur = SF(F_DUR), *s_ttl = SF(F_TTL),
          *s_e2e = SF(F_E2E), *s_pp = SF(F_PP), *s_tmr = SF(F_TMR);
    float* node_load = tnp + (size_t)T_LOAD * NP;
    float* edge_used = te + (size_t)T_USED * E;

    // ---- per-replica views ----------------------------------------------
    const size_t fm = (size_t)b * M;
    float* rel_node = a.rel_node + (size_t)b * H * NP;
    float* rel_edge = a.rel_edge + (size_t)b * H * E;
    const float* schedule = a.schedule + (size_t)b * NCS * N;
    int* flow_counts = a.run_flow_counts + (size_t)b * NCS * N;
    const float* path_delay = a.path_delay + (size_t)b * a.topo_nn_stride;
    const int* next_hop = a.next_hop + (size_t)b * a.topo_nn_stride;
    const int* adj_edge_id = a.adj_edge_id + (size_t)b * a.topo_nn_stride;
    const size_t tro = (size_t)b * a.traf_stride;
    const float* arr_time = a.arr_time + tro;

    // ---- load the flow table, the tables and the scalars -----------------
    if (own) {
        s_ph[m] = a.phase[fm + m];       s_sfc[m] = a.sfc[fm + m];
        s_pos[m] = a.position[fm + m];   s_nd[m] = a.node[fm + m];
        s_dst[m] = a.dest[fm + m];       s_hn[m] = a.hop_next[fm + m];
        s_eg[m] = a.egress[fm + m];      s_dr[m] = a.dr[fm + m];
        s_dur[m] = a.duration[fm + m];   s_ttl[m] = a.ttl[fm + m];
        s_e2e[m] = a.e2e[fm + m];        s_pp[m] = a.pend_path[fm + m];
        s_tmr[m] = a.timer[fm + m];
    }
    for (int i = tid; i < NP; i += nth) {
        const size_t g = (size_t)b * NP + i;
        node_load[i] = a.node_load[g];
        tnp[(size_t)T_LAST * NP + i] = a.sf_last_active[g];
        tnp[(size_t)T_STARTUP * NP + i] = a.sf_startup[g];
        tnp[(size_t)T_PROCESSED * NP + i] = a.run_processed_traffic[g];
        s_avail[i] = a.sf_available[g] ? 1 : 0;
        s_placed[i] = a.placed[g] ? 1 : 0;
    }
    for (int i = tid; i < E; i += nth) {
        edge_used[i] = a.edge_used[(size_t)b * E + i];
        te[(size_t)T_ECAP * E + i] = a.edge_cap[(size_t)b * a.topo_e_stride + i];
        te[(size_t)T_EDELAY * E + i] =
            a.edge_delay[(size_t)b * a.topo_e_stride + i];
        te[(size_t)T_PASSED * E + i] = a.run_passed_traffic[(size_t)b * E + i];
    }
    for (int i = tid; i < N; i += nth) {
        tn[(size_t)T_CAP * N + i] = a.cap_now[(size_t)b * N + i];
        tn[(size_t)T_REQ_NODE * N + i] = a.run_requested_node[(size_t)b * N + i];
        tn[(size_t)T_MAX_USE * N + i] = a.run_max_node_usage[(size_t)b * N + i];
        s_dropnode[i] = a.run_dropped_per_node[(size_t)b * N + i];
    }
    for (int i = tid; i < NCS; i += nth)
        s_req_cell[i] = a.run_requested[(size_t)b * NCS + i];
    for (int i = tid; i < C; i += nth) s_chain_len[i] = a.chain_len[i];
    for (int i = tid; i < C * S; i += nth) s_chain_sf[i] = a.chain_sf[i];
    for (int i = tid; i < 3 * P; i += nth) s_proc[i] = a.proc[i];
    for (int i = tid; i < P; i += nth) s_rf[i] = a.rf_id[i];
    if (tid == 0) {
        sc.cursor = a.cursor[b];             sc.truncated = a.truncated[b];
        sc.generated = a.generated[b];       sc.processed = a.processed[b];
        sc.dropped = a.dropped[b];           sc.active = a.active[b];
        for (int q = 0; q < 4; ++q) sc.drop_reasons[q] = a.drop_reasons[b * 4 + q];
        sc.num_proc_delay = a.num_proc_delay[b];
        sc.num_path_delay = a.num_path_delay[b];
        sc.run_generated = a.run_generated[b];
        sc.run_processed = a.run_processed[b];
        sc.run_dropped = a.run_dropped[b];
        sc.serial = 0;
        sc.sum_proc_delay = a.sum_proc_delay[b];
        sc.sum_path_delay = a.sum_path_delay[b];
        sc.sum_e2e = a.sum_e2e[b];
        sc.run_e2e_sum = a.run_e2e_sum[b];
        sc.run_e2e_max = a.run_e2e_max[b];
        sc.run_path_delay_sum = a.run_path_delay_sum[b];
        for (int s = 0; s < N_STAGES; ++s) sc.clk[s] = 0;
    }
    float tt = a.t[b];         // every thread keeps the clock
    float t_prev = tt;
#ifdef SUBSTEP_STAGE_CLOCKS
    long long clk_last = 0;
#endif
    __syncthreads();

    for (int k = 0; k < K; ++k) {
#ifdef SUBSTEP_STAGE_CLOCKS
        if (tid == 0) clk_last = clock64();
#endif
        const int g = __float2int_rn(__fdiv_rn(tt, dt));  // round half even
        int ridx = g % H;
        if (ridx < 0) ridx += H;
        if (tid == 0) {
            sc.sub_drops = 0;
            for (int q = 0; q < 4; ++q) sc.sub_reasons[q] = 0;
        }

        // ---- 1. capacity releases (after the last substep's activity) ----
        for (int i = tid; i < NP; i += nth) {
            float x = node_load[i];
            if (k > 0) settle_idle(i, x, t_prev, gc, vnf_timeout, tnp, NP,
                                   s_avail, s_placed);
            x = x - rel_node[(size_t)ridx * NP + i];
            x = x < 0.0f ? 0.0f : x;
            node_load[i] = x;
            rel_node[(size_t)ridx * NP + i] = 0.0f;
            s_avail[i] = (s_avail[i] && (s_placed[i] || x > EPS)) ? 1 : 0;
        }
        for (int i = tid; i < E; i += nth) {
            float x = edge_used[i] - rel_edge[(size_t)ridx * E + i];
            edge_used[i] = x < 0.0f ? 0.0f : x;
            rel_edge[(size_t)ridx * E + i] = 0.0f;
        }

        // ---- 2. timers ---------------------------------------------------
        bool arrived = false, cont = false, depart_hop = false,
             need_a = false;
        float z = 0.0f;
        if (own) {
            if (a.noise != nullptr) z = __ldg(a.noise + ((size_t)b * K + k) * M + m);
            int ph = s_ph[m];
            float tmr = s_tmr[m];
            if (ph == PH_HOP || ph == PH_PROC) tmr = tmr - dt;
            const bool proc_done = ph == PH_PROC && tmr <= EPS;
            const bool hop_done = ph == PH_HOP && tmr <= EPS;
            const int pos = s_pos[m] + (proc_done ? 1 : 0);
            if (proc_done) ph = PH_DECIDE;
            const int nd = hop_done ? s_hn[m] : s_nd[m];
            arrived = hop_done && nd == s_dst[m];
            cont = hop_done && !arrived;
            const float pc = arrived ? s_pp[m] : 0.0f;
            s_e2e[m] = s_e2e[m] + pc;
            s_ttl[m] = s_ttl[m] - pc;
            UF(U_PC)[m] = pc;
            const int sfc = s_sfc[m];
            const int cl = (sfc >= 0 && sfc < C) ? s_chain_len[sfc] : 0;
            depart_hop = arrived && pos >= cl;
            need_a = arrived && !(pos >= cl);
            s_ph[m] = ph; s_tmr[m] = tmr; s_pos[m] = pos; s_nd[m] = nd;
        }
        store_ballot(MASK(MK_FREE), own && s_ph[m] == PH_FREE);
        store_ballot(MASK(MK_ARRIVED), arrived);
        // arrival candidates: lanes 0..7 of warp 0
        if (tid < 32) {
            const int cursor = sc.cursor;
            bool due = false, late = false;
            if (tid < ARRIVALS_PER_SUBSTEP) {
                const int cand = cursor + tid;
                const int cc = clampi(cand, 0, F - 1);
                const float at = __ldg(arr_time + cc);
                due = at < (tt + dt) - EPS && cand < F && isfinite(at);
                late = at < tt - EPS;
                sc.cand_ing[tid] = __ldg(a.arr_ingress + tro + cc);
                sc.cand_sfc[tid] = __ldg(a.arr_sfc + tro + cc);
                sc.cand_eg[tid] = __ldg(a.arr_egress + tro + cc);
                sc.cand_dr[tid] = __ldg(a.arr_dr + tro + cc);
                sc.cand_dur[tid] = __ldg(a.arr_duration + tro + cc);
                sc.cand_ttl[tid] = __ldg(a.arr_ttl + tro + cc);
            }
            const unsigned dm = __ballot_sync(FULL_MASK, due);
            const unsigned lm = __ballot_sync(FULL_MASK, late);
            if (tid == 0) { sc.due = dm; sc.late = lm; }
        }
        STAGE_SYNC(ST_RELEASE_TIMERS);

        // ---- 3. arrivals: the r-th free slot takes the r-th due one -------
        {
            const unsigned due = sc.due;
            const int nfree = count_all(MASK(MK_FREE), nw);
            const int ndue = __popc(due);
            const int nsp = ndue < nfree ? ndue : nfree;
            if (own && s_ph[m] == PH_FREE) {
                const int r = count_before(MASK(MK_FREE), m);
                if (r < nsp) {
                    unsigned bits = due;
                    for (int q = 0; q < r; ++q) bits &= bits - 1;
                    const int c = __ffs(bits) - 1;
                    s_ph[m] = PH_DECIDE; s_nd[m] = sc.cand_ing[c];
                    s_pos[m] = 0; s_sfc[m] = sc.cand_sfc[c];
                    s_eg[m] = sc.cand_eg[c]; s_dst[m] = -1;
                    s_dr[m] = sc.cand_dr[c]; s_dur[m] = sc.cand_dur[c];
                    s_ttl[m] = sc.cand_ttl[c]; s_e2e[m] = 0.0f;
                    s_pp[m] = 0.0f;
                }
            }
            if (tid == 0) {
                float path_add = 0.0f;
                FOR_SET(j, MASK(MK_ARRIVED), nw, 0) path_add += UF(U_PC)[j];
                sc.sum_path_delay += path_add;
                sc.num_path_delay += count_all(MASK(MK_ARRIVED), nw);
                sc.run_path_delay_sum += path_add;
                float* req_node = tn + (size_t)T_REQ_NODE * N;
                unsigned bits = due;
                int nlate = 0;
                for (int q = 0; q < nsp; ++q) {
                    const int c = __ffs(bits) - 1;
                    bits &= bits - 1;
                    nlate += (sc.late >> c) & 1u;
                    const int ing = sc.cand_ing[c];
                    if (ing >= 0 && ing < N)
                        req_node[ing] = req_node[ing] + sc.cand_dr[c];
                }
                sc.cursor += nsp;
                sc.truncated += nlate;
                sc.generated += nsp;
                sc.run_generated += nsp;
                sc.active += nsp;
            }
        }
        CLOCK_SPLIT(ST_ARRIVALS);

        // decisions, forwarding and grouping in one scope: what the
        // per-slot results need after the admission rounds goes through
        // shared memory (I_FLAGS, F_PDEL, F_PD, I_NH), not registers
        int pos_e = 0, pos_n = 0;
        // a pipeline without requests admits nothing and skips its rounds;
        // with neither, the grouping goes too
        bool link_on = false, node_on = false;
        {
            // ---- 4. decisions ------------------------------------------------
            bool drop_ttl0 = false, decide = false, to_eg = false, wrr = false;
            int cell = 0, sf_now = 0, ext_dst = 0;
            if (own) {
                const int ph = s_ph[m], pos = s_pos[m], nd = s_nd[m];
                const int sfc = s_sfc[m];
                const float ttl = s_ttl[m];
                const int sfc_c = clampi(sfc, 0, C - 1);
                const int cl = (sfc >= 0 && sfc < C) ? s_chain_len[sfc] : 0;
                const bool to_eg_flag = pos >= cl;
                const bool deciding = ph == PH_DECIDE;
                drop_ttl0 = deciding && ttl <= EPS;
                decide = deciding && !drop_ttl0;
                to_eg = decide && to_eg_flag;
                if (to_eg && s_eg[m] < 0) s_eg[m] = nd;
                wrr = decide && !to_eg_flag;
                // per-flow control: a flow without a decision stays parked
                if (ext != nullptr && wrr) {
                    const int e = __ldg(ext + m);
                    wrr = e >= 0;
                    ext_dst = clampi(e, 0, N - 1);
                }
                sf_now = sf_at(s_chain_sf, sfc, pos, C, S);
                cell = (nd * C + sfc_c) * S + clampi(pos, 0, S - 1);
                UI(U_CELL)[m] = cell;
            }
            store_ballot(MASK(MK_WRR), wrr);
            STAGE_SYNC(ST_DECISIONS);

            // WRR: rank among same-cell decisions before this slot; the first
            // of each cell adds the cell's requested traffic in slot order
            const bool cell_ok = cell >= 0 && cell < NCS;
            int rank = 0;
            int dst = own ? s_dst[m] : 0;
            const int n_wrr = count_all(MASK(MK_WRR), nw);
            if (wrr) {
                for (int j = next_set(MASK(MK_WRR), nw, 0); j < m;
                     j = next_set(MASK(MK_WRR), nw, j + 1))
                    rank += UI(U_CELL)[j] == cell;
                if (rank == 0 && cell_ok)
                    s_req_cell[cell] = s_req_cell[cell] +
                        add_run(0.0f, MASK(MK_WRR), nw, UI(U_CELL), s_dr, m, cell);
            }
            // rank levels: below R - 1 a cell has at most one chooser, so it
            // reads and adds in one step; the last level's choosers of one cell
            // all read before any adds
            for (int r = 0; ext == nullptr && r < R && r < n_wrr; ++r) {
                const bool last = r == R - 1;
                const bool sel = wrr && (last ? rank >= r : rank == r);
                // each warp chooses for its selected slots in turn
                int choice = 0;
                for (unsigned todo = __ballot_sync(FULL_MASK, sel); todo != 0;
                     todo &= todo - 1) {
                    const int src = __ffs(todo) - 1;
                    const int ch = wrr_choice(flow_counts, schedule,
                                              __shfl_sync(FULL_MASK, cell, src),
                                              NCS, N);
                    if ((tid & 31) == src) choice = ch;
                }
                if (sel) dst = choice;
                if (last) __syncthreads();
                if (sel && cell_ok) atomicAdd(&flow_counts[(size_t)cell * N + choice], 1);
                if (!last && r + 1 < n_wrr) __syncthreads();
            }
            if (ext != nullptr) {
                // place-on-decision: the first decided slot of each
                // (node, SF) cell installs it if absent (a cell that was
                // not available starts its startup clock, every new one
                // its idle clock), before forwarding reads s_placed.
                // U_PC is free here: the path credits were read before
                // the decisions' barrier
                if (wrr) dst = ext_dst;
                const int pc = (wrr && sf_now < P) ? dst * P + sf_now : -1;
                if (own) UI(U_PC)[m] = pc;
                __syncthreads();
                if (pc >= 0 && first_of(MASK(MK_WRR), nw, UI(U_PC), m, pc)
                    && !s_placed[pc]) {
                    if (!s_avail[pc]) tnp[(size_t)T_STARTUP * NP + pc] = tt;
                    tnp[(size_t)T_LAST * NP + pc] = tt;
                    s_avail[pc] = 1;
                    s_placed[pc] = 1;
                }
                __syncthreads();
            }
            CLOCK_SPLIT(ST_WRR);

            // ---- 5. forwarding -----------------------------------------------
            bool drop_ttl_path = false, hop_req = false, start_path = false,
                 depart_stay = false, drop_unplaced = false, want = false,
                 drop_ttl_pd = false;
            float pd_path = 0.0f, pdel = 0.0f;
            float hr = 0.0f, cap = 0.0f;
            int nh = 0, eid_c = 0, nd = 0;
            bool req = false;
            if (own) {
                if (to_eg) dst = s_eg[m];
                s_dst[m] = dst;
                nd = s_nd[m];
                float ttl = s_ttl[m];
                // per-flow control forwards the decided flows only
                const bool fwd = ext != nullptr ? (to_eg || wrr) : decide;
                const bool stay = fwd && dst == nd;
                depart_stay = to_eg && stay;
                const bool need_b = wrr && stay;
                start_path = fwd && !stay;
                const int dc = dst < 0 ? 0 : dst;
                const bool nv = nd >= 0 && nd < N;
                const bool nn_ok = nv && dc < N;
                if (nn_ok) {
                    const float pdv = __ldg(path_delay + nd * N + dc);
                    pd_path = isfinite(pdv) ? pdv : 1e30f;
                }
                cap = nv ? tn[(size_t)T_CAP * N + nd] : 0.0f;
                drop_ttl_path = start_path && (ttl - pd_path <= EPS);
                if (drop_ttl_path) ttl = 0.0f;
                start_path = start_path && !drop_ttl_path;
                hop_req = cont || start_path;
                nh = nn_ok ? __ldg(next_hop + nd * N + dc) : 0;
                if (nh < 0) nh = 0;
                const int eid = (nv && nh < N) ? __ldg(adj_edge_id + nd * N + nh) : 0;
                eid_c = eid < 0 ? 0 : eid;
                const bool ev = eid_c < E;
                hr = ev ? (te[(size_t)T_ECAP * E + eid_c] - edge_used[eid_c]) + EPS
                        : 0.0f;
                const bool need_proc = need_a || need_b;
                const bool sf_ok = nv && sf_now < P && s_placed[nd * P + sf_now];
                drop_unplaced = need_proc && !sf_ok;
                want = need_proc && sf_ok;
                float pmean = 0.0f, pstd = 0.0f;
                if (sf_now < P) {
                    pmean = s_proc[sf_now * 3];
                    pstd = s_proc[sf_now * 3 + 1];
                }
                pdel = a.noise != nullptr ? fabsf(__fadd_rn(__fmul_rn(z, pstd), pmean))
                                          : fabsf(pmean);
                drop_ttl_pd = want && (ttl - pdel <= EPS);
                want = want && !drop_ttl_pd;
                s_ttl[m] = ttl;
                req = hop_req && eid >= 0;
                s_key[m] = make_int2(eid_c, nd);
                SI(I_FLAGS)[m] = (drop_ttl0 ? FL_DROP_TTL0 : 0)
                    | (drop_ttl_path ? FL_DROP_TTL_PATH : 0)
                    | (hop_req ? FL_HOP_REQ : 0) | (start_path ? FL_START_PATH : 0)
                    | (depart_stay ? FL_DEPART_STAY : 0)
                    | (depart_hop ? FL_DEPART_HOP : 0)
                    | (drop_unplaced ? FL_DROP_UNPLACED : 0) | (want ? FL_WANT : 0)
                    | (drop_ttl_pd ? FL_DROP_TTL_PD : 0);
                SF(F_PDEL)[m] = pdel;
                SF(F_PD)[m] = pd_path;
                SI(I_NH)[m] = nh;
            }
            store_ballot(MASK(MK_REQ), req);
            store_ballot(MASK(MK_WANT), want);
            STAGE_SYNC(ST_FORWARD);
            link_on = count_all(MASK(MK_REQ), nw) > 0;
            node_on = count_all(MASK(MK_WANT), nw) > 0;

            // ---- grouping: sorted position of (key, slot) by counting; the
            // keys strictly below give the start of the key's run --------------
            if (own && (link_on || node_on)) {
                const int2 km = s_key[m];
                // keys below, and equal keys of lower slots, come first
                int lt_e = 0, lt_n = 0, eq_e = 0, eq_n = 0;
#pragma unroll 8
                for (int i = 0; i < M; ++i) {
                    const int2 ki = s_key[i];
                    const int lower = i < m;
                    lt_e += ki.x < km.x;
                    lt_n += ki.y < km.y;
                    eq_e += (ki.x == km.x) & lower;
                    eq_n += (ki.y == km.y) & lower;
                }
                pos_e = lt_e + eq_e;
                pos_n = lt_n + eq_n;
                SI(I_ST_E)[pos_e] = lt_e;
                SI(I_REQ_E)[pos_e] = req ? 1 : 0;
                SF(F_DR_E)[pos_e] = s_dr[m];
                SF(F_HR_E)[pos_e] = hr;
                SI(I_ST_N)[pos_n] = lt_n;
                SI(I_SF_N)[pos_n] = sf_now;
                SI(I_ND_N)[pos_n] = nd;
                SI(I_WANT_N)[pos_n] = want ? 1 : 0;
                SF(F_DR_N)[pos_n] = s_dr[m];
                SF(F_CAP_N)[pos_n] = cap;
            }
            if (tid == 0) {
                for (int q = 0; q < 2; ++q) {
                    reset_span(sc.span[0][q]);
                    reset_span(sc.span[1][q]);
                }
            }
            STAGE_SYNC(ST_GROUP);
        }

        // ---- link and node admission, ITERS rounds side by side: the
        // prefix sums of the sorted values against the run-start prefix.
        // A round whose admissions equal the last round's would repeat it,
        // so the rounds stop there (same results, fewer rounds) ------------
        {
            const int p = tid;        // one thread per sorted position
            const bool pv = p < M;
            const bool req_p = link_on && pv && SI(I_REQ_E)[p];
            const bool want_p = node_on && pv && SI(I_WANT_N)[p];
            bool adm_e = req_p, adm_n = want_p, changed = pv;
            float dem = 0.0f;
            const int col = pv ? SI(I_SF_N)[p] : -1;
            const int lane = tid & 31, warp = tid >> 5;
            const int node_serial_tid = nth > 32 ? 32 : 0;
            for (int it = 0; it < ITERS && (link_on || node_on); ++it) {
                int* span_e = sc.span[it & 1][0];
                int* span_n = sc.span[it & 1][1];
                const float ve = adm_e ? SF(F_DR_E)[p] : 0.0f;
                const float vn = adm_n ? SF(F_DR_N)[p] : 0.0f;
                if (pv) {
                    UF(U_V_E)[p] = ve;
                    UF(U_V_N)[p] = vn;
                }
                // warp totals and the spans of the nonzero values
                if (link_on) {
                    const double x = warp_scan_sparse(ve);
                    if (lane == 31) wtot[warp] = x;
                    reduce_span(span_e, ve);
                }
                if (node_on) {
                    for (int c = 0; c < P; ++c) {
                        const double x = warp_scan_sparse(col == c ? vn : 0.0f);
                        if (lane == 31) wtot[(c + 1) * MAX_WARPS + warp] = x;
                    }
                    reduce_span(span_n, vn);
                }
                if (!__syncthreads_or(changed)) {
                    STAGE_MARK(ST_SCAN);
                    break;
                }
                if (tid == 0) {
                    reset_span(sc.span[(it + 1) & 1][0]);
                    reset_span(sc.span[(it + 1) & 1][1]);
                }
                if (link_on && order_free(span_e)) {
                    const double x = block_prefix(warp_scan_sparse(ve), wtot);
                    if (pv) {
                        const float cs = (float)x;
                        UF(U_CS_E)[p] = cs;
                        UF(U_BASE_E)[p] = cs - ve;
                    }
                } else if (link_on && tid == 0) {
                    double acc = 0.0;
                    for (int q = 0; q < M; ++q) {
                        const float v = UF(U_V_E)[q];
                        acc += (double)v;
                        const float cs = (float)acc;
                        UF(U_CS_E)[q] = cs;
                        UF(U_BASE_E)[q] = cs - v;
                    }
                    atomicAdd(&sc.serial, 1);
                }
                if (node_on && order_free(span_n)) {
                    for (int c = 0; c < P; ++c) {
                        const double x = block_prefix(
                            warp_scan_sparse(col == c ? vn : 0.0f),
                            wtot + (c + 1) * MAX_WARPS);
                        if (pv) {
                            const float cs = (float)x;
                            s_csn[p * P + c] = cs;
                            if (col == c) UF(U_BASE_N)[p] = cs - vn;
                        }
                    }
                } else if (node_on && tid == node_serial_tid) {
                    for (int c = 0; c < P; ++c) {
                        double acc = 0.0;
                        for (int q = 0; q < M; ++q) {
                            const bool own_col = SI(I_SF_N)[q] == c;
                            const float v = own_col ? UF(U_V_N)[q] : 0.0f;
                            acc += (double)v;
                            const float cs = (float)acc;
                            s_csn[q * P + c] = cs;
                            if (own_col) UF(U_BASE_N)[q] = cs - v;
                        }
                    }
                    atomicAdd(&sc.serial, 1);
                }
                STAGE_SYNC(ST_SCAN);
                if (pv) {
                    const bool was_e = adm_e, was_n = adm_n;
                    if (link_on)
                        adm_e = req_p && (UF(U_CS_E)[p] - UF(U_BASE_E)[SI(I_ST_E)[p]]
                                          <= SF(F_HR_E)[p]);
                    if (node_on) {
                        const int ndp = SI(I_ND_N)[p], stn = SI(I_ST_N)[p];
                        const bool nv = ndp >= 0 && ndp < N;
                        // the run start's base: its prefix sums, less its
                        // value in its own SF's column (x - 0 is x)
                        const int col_st = SI(I_SF_N)[stn];
                        dem = 0.0f;
                        for (int c = 0; c < P; ++c) {
                            const float base = nv ? node_load[ndp * P + c] : 0.0f;
                            const bool av = nv && s_avail[ndp * P + c];
                            const float run_base = col_st == c
                                ? UF(U_BASE_N)[stn] : s_csn[stn * P + c];
                            const float lp = (base + s_csn[p * P + c])
                                             - run_base;
                            dem = dem + (av ? resource_fn(s_rf[c], lp) : 0.0f);
                        }
                        adm_n = want_p && dem <= SF(F_CAP_N)[p] + EPS;
                    }
                    changed = adm_e != was_e || adm_n != was_n;
                }
                CLOCK_SPLIT(ST_TEST);
            }
            if (pv) {
                SI(I_ADM_E)[p] = adm_e ? 1 : 0;
                SI(I_ADM_N)[p] = adm_n ? 1 : 0;
                SF(F_DEM_N)[p] = dem;
            }
        }
        STAGE_SYNC(ST_TEST);

        // ---- per-slot results: link, processing, release rows, drops -----
        bool admitted = false, admitted_n = false, depart = false;
        // each slot's release-ring value, read ahead of the ring adds
        float ring_e = 0.0f, ring_n = 0.0f;
        if (own) {
            const int fl = SI(I_FLAGS)[m];
            const bool drop_ttl0 = fl & FL_DROP_TTL0;
            const bool drop_ttl_path = fl & FL_DROP_TTL_PATH;
            const bool hop_req = fl & FL_HOP_REQ;
            const bool start_path = fl & FL_START_PATH;
            const bool depart_stay = fl & FL_DEPART_STAY;
            const bool depart_hop = fl & FL_DEPART_HOP;
            const bool drop_unplaced = fl & FL_DROP_UNPLACED;
            const bool want = fl & FL_WANT;
            const bool drop_ttl_pd = fl & FL_DROP_TTL_PD;
            const float pd_path = SF(F_PD)[m], pdel = SF(F_PDEL)[m];
            const int2 key = s_key[m];
            const int eid_c = key.x, nd = key.y;
            const float hop_delay = eid_c < E ? te[(size_t)T_EDELAY * E + eid_c]
                                              : 0.0f;
            const int sf_now = sf_at(s_chain_sf, s_sfc[m], s_pos[m], C, S);
            const float pstart = sf_now < P ? s_proc[sf_now * 3 + 2] : 0.0f;
            admitted = SI(I_ADM_E)[pos_e] != 0;
            admitted_n = SI(I_ADM_N)[pos_n] != 0;
            UF(U_DEM)[m] = SF(F_DEM_N)[pos_n];
            UI(U_TEDGE)[m] = (admitted && eid_c < E) ? eid_c : -1;
            int trele = -1;
            if (admitted) {
                const int h = ring_row(ridx, s_dur[m] + hop_delay, dt, H);
                const long long fi = (long long)h * E + eid_c;
                if (fi >= 0 && fi < (long long)H * E) trele = (int)fi;
            }
            UI(U_TRELE)[m] = trele;
            if (trele >= 0) ring_e = rel_edge[trele];
            const bool drop_link = hop_req && !admitted;
            if (admitted) {
                if (start_path) s_pp[m] = pd_path;
                s_hn[m] = SI(I_NH)[m];
                s_tmr[m] = hop_delay;
                s_ph[m] = PH_HOP;
            }
            // processing
            float ttl = s_ttl[m];
            if (drop_ttl_pd) ttl = 0.0f;
            const float pw = want ? pdel : 0.0f;
            s_e2e[m] = s_e2e[m] + pw;
            ttl = ttl - pw;
            UF(U_PW)[m] = pw;
            const bool nv = nd >= 0 && nd < N;
            const long long fn = (long long)nd * P + sf_now;
            UI(U_TNODE)[m] = (admitted_n && fn >= 0 && fn < NP) ? (int)fn : -1;
            const float st_at = (nv && sf_now < P)
                ? tnp[(size_t)T_STARTUP * NP + nd * P + sf_now] : 0.0f;
            float sw = (st_at + pstart) - tt;
            if (sw < 0.0f) sw = 0.0f;
            const bool drop_nodecap = want && !admitted_n;
            const bool drop_ttl_sw = admitted_n && (ttl - sw <= EPS) && sw > EPS;
            if (drop_ttl_sw) ttl = 0.0f;
            const bool started = admitted_n && !drop_ttl_sw;
            const float sws = started ? sw : 0.0f;
            s_e2e[m] = s_e2e[m] + sws;
            ttl = ttl - sws;
            s_ttl[m] = ttl;
            const float busy = started ? sw + pdel : 0.0f;
            if (started) { s_tmr[m] = busy; s_ph[m] = PH_PROC; }
            const float hold = started ? busy + s_dur[m] : dt;
            int treln = -1;
            if (started || drop_ttl_sw) {
                const int h = ring_row(ridx, hold, dt, H);
                const long long fi = (long long)h * NP + (long long)nd * P + sf_now;
                if (fi >= 0 && fi < (long long)H * NP) treln = (int)fi;
            }
            UI(U_TRELN)[m] = treln;
            if (treln >= 0) ring_n = rel_node[treln];
            // departures & drops
            depart = depart_hop || depart_stay;
            UF(U_DEP)[m] = depart ? s_e2e[m] : 0.0f;
            const bool ttl_out = ttl <= EPS;
            const bool masks7[7] = {drop_ttl0, drop_ttl_path, drop_link,
                                    drop_unplaced, drop_ttl_pd, drop_nodecap,
                                    drop_ttl_sw};
            bool any_drop = false;
            for (int q = 0; q < 7; ++q) {
                if (!masks7[q]) continue;
                any_drop = true;
                const int reason = ttl_out ? DROP_TTL
                    : (q == 0 ? DROP_DECISION
                       : (q <= 2 ? DROP_LINK_CAP : DROP_NODE_CAP));
                atomicAdd(&sc.sub_reasons[reason], 1);
            }
            if (any_drop) {
                atomicAdd(&sc.sub_drops, 1);
                if (nv) atomicAdd(&s_dropnode[nd], 1);
            }
            if (depart || any_drop) s_ph[m] = PH_FREE;
        }
        store_ballot(MASK(MK_ADM_E), admitted);
        store_ballot(MASK(MK_ADM_N), admitted_n);
        store_ballot(MASK(MK_DEP), depart);
        STAGE_SYNC(ST_RESULTS);

        // ---- ring adds: the first slot of each row adds the row's holds in
        // slot order -------------------------------------------------------
        if (admitted) {
            const int t = UI(U_TRELE)[m];
            if (t >= 0 && first_of(MASK(MK_ADM_E), nw, UI(U_TRELE), m, t))
                rel_edge[t] = add_run(ring_e, MASK(MK_ADM_E), nw,
                                      UI(U_TRELE), s_dr, m, t);
        }
        if (admitted_n) {
            const int t = UI(U_TRELN)[m];
            if (t >= 0 && first_of(MASK(MK_ADM_N), nw, UI(U_TRELN), m, t))
                rel_node[t] = add_run(ring_n, MASK(MK_ADM_N), nw,
                                      UI(U_TRELN), s_dr, m, t);
        }
        CLOCK_SPLIT(ST_RING_ADDS);

        // ---- scatters into the tables, node usage, the slot sums ---------
        if (admitted) {
            const int t = UI(U_TEDGE)[m];
            if (t >= 0 && first_of(MASK(MK_ADM_E), nw, UI(U_TEDGE), m, t)) {
                const float acc = add_run(0.0f, MASK(MK_ADM_E), nw,
                                          UI(U_TEDGE), s_dr, m, t);
                edge_used[t] = edge_used[t] + acc;
                te[(size_t)T_PASSED * E + t] = te[(size_t)T_PASSED * E + t] + acc;
            }
        }
        if (admitted_n) {
            const int t = UI(U_TNODE)[m];
            if (t >= 0 && first_of(MASK(MK_ADM_N), nw, UI(U_TNODE), m, t)) {
                const float acc = add_run(0.0f, MASK(MK_ADM_N), nw,
                                          UI(U_TNODE), s_dr, m, t);
                node_load[t] = node_load[t] + acc;
                tnp[(size_t)T_PROCESSED * NP + t] =
                    tnp[(size_t)T_PROCESSED * NP + t] + acc;
            }
        }
        // node usage on the last threads, the sums on threads 0 and 32
        for (int n = nth - 1 - tid; n < N; n += nth) {
            float mx = 0.0f;
            FOR_SET(j, MASK(MK_ADM_N), nw, 0)
                if (s_nd[j] == n) {
                    const float v = UF(U_DEM)[j];
                    mx = v > mx ? v : mx;
                }
            float* mu = tn + (size_t)T_MAX_USE * N + n;
            if (mx > *mu) *mu = mx;
        }
        if (tid == 0) {
            float s = 0.0f;
            FOR_SET(j, MASK(MK_WANT), nw, 0) s += UF(U_PW)[j];
            sc.sum_proc_delay += s;
            sc.num_proc_delay += count_all(MASK(MK_WANT), nw);
        }
        if (tid == (nth > 32 ? 32 : 0)) {
            float dep_sum = 0.0f, dep_max = 0.0f;
            FOR_SET(j, MASK(MK_DEP), nw, 0) {
                const float v = UF(U_DEP)[j];
                dep_sum += v;
                dep_max = v > dep_max ? v : dep_max;
            }
            const int n_dep = count_all(MASK(MK_DEP), nw), n_drop = sc.sub_drops;
            sc.processed += n_dep;
            sc.run_processed += n_dep;
            sc.sum_e2e += dep_sum;
            sc.run_e2e_sum += dep_sum;
            if (dep_max > sc.run_e2e_max) sc.run_e2e_max = dep_max;
            for (int q = 0; q < 4; ++q) sc.drop_reasons[q] += sc.sub_reasons[q];
            sc.dropped += n_drop;
            sc.run_dropped += n_drop;
            sc.active -= n_dep + n_drop;
        }
        t_prev = tt;
        tt = tt + dt;
        STAGE_SYNC(ST_SCATTERS);
    }

    // ---- the last substep's activity, then store everything --------------
    for (int i = tid; i < NP; i += nth)
        if (K > 0) settle_idle(i, node_load[i], t_prev, gc, vnf_timeout, tnp,
                               NP, s_avail, s_placed);
    if (own) {
        a.phase[fm + m] = s_ph[m];       a.sfc[fm + m] = s_sfc[m];
        a.position[fm + m] = s_pos[m];   a.node[fm + m] = s_nd[m];
        a.dest[fm + m] = s_dst[m];       a.hop_next[fm + m] = s_hn[m];
        a.egress[fm + m] = s_eg[m];      a.dr[fm + m] = s_dr[m];
        a.duration[fm + m] = s_dur[m];   a.ttl[fm + m] = s_ttl[m];
        a.e2e[fm + m] = s_e2e[m];        a.pend_path[fm + m] = s_pp[m];
        a.timer[fm + m] = s_tmr[m];
    }
    for (int i = tid; i < NP; i += nth) {
        const size_t g = (size_t)b * NP + i;
        a.node_load[g] = node_load[i];
        a.sf_last_active[g] = tnp[(size_t)T_LAST * NP + i];
        a.run_processed_traffic[g] = tnp[(size_t)T_PROCESSED * NP + i];
        a.sf_available[g] = s_avail[i] ? 1 : 0;
        if (ext != nullptr || gc) a.placed[g] = s_placed[i] ? 1 : 0;
        if (ext != nullptr)
            a.sf_startup[g] = tnp[(size_t)T_STARTUP * NP + i];
    }
    for (int i = tid; i < E; i += nth) {
        a.edge_used[(size_t)b * E + i] = edge_used[i];
        a.run_passed_traffic[(size_t)b * E + i] = te[(size_t)T_PASSED * E + i];
    }
    for (int i = tid; i < N; i += nth) {
        a.run_requested_node[(size_t)b * N + i] = tn[(size_t)T_REQ_NODE * N + i];
        a.run_max_node_usage[(size_t)b * N + i] = tn[(size_t)T_MAX_USE * N + i];
        a.run_dropped_per_node[(size_t)b * N + i] = s_dropnode[i];
    }
    for (int i = tid; i < NCS; i += nth)
        a.run_requested[(size_t)b * NCS + i] = s_req_cell[i];
    if (tid == 0) {
        a.t[b] = tt;
        a.cursor[b] = sc.cursor;             a.truncated[b] = sc.truncated;
        a.generated[b] = sc.generated;       a.processed[b] = sc.processed;
        a.dropped[b] = sc.dropped;           a.active[b] = sc.active;
        for (int q = 0; q < 4; ++q) a.drop_reasons[b * 4 + q] = sc.drop_reasons[q];
        a.num_proc_delay[b] = sc.num_proc_delay;
        a.num_path_delay[b] = sc.num_path_delay;
        a.run_generated[b] = sc.run_generated;
        a.run_processed[b] = sc.run_processed;
        a.run_dropped[b] = sc.run_dropped;
        a.sum_proc_delay[b] = sc.sum_proc_delay;
        a.sum_path_delay[b] = sc.sum_path_delay;
        a.sum_e2e[b] = sc.sum_e2e;
        a.run_e2e_sum[b] = sc.run_e2e_sum;
        a.run_e2e_max[b] = sc.run_e2e_max;
        a.run_path_delay_sum[b] = sc.run_path_delay_sum;
        if (sc.serial > 0 && a.serial_rounds != nullptr)
            atomicAdd(a.serial_rounds, (unsigned long long)sc.serial);
#ifdef SUBSTEP_STAGE_CLOCKS
        if (a.stage_clocks != nullptr)
            for (int s = 0; s < N_STAGES; ++s)
                a.stage_clocks[(size_t)b * N_STAGES + s] = sc.clk[s];
#endif
    }
}

extern "C" long long substep_args_size() {
    return (long long)sizeof(SubstepArgs);
}

extern "C" long long substep_smem_bytes(const SubstepArgs* args) {
    return (long long)layout_for(args->M, args->N, args->C, args->S, args->P,
                                 args->E).total;
}

// stages the clocked build reports (0 in a build without clocks)
extern "C" int substep_n_stages() {
#ifdef SUBSTEP_STAGE_CLOCKS
    return N_STAGES;
#else
    return 0;
#endif
}

template <int MAX_BLOCK, bool kPerFlow>
static int launch_blocks(const SubstepArgs* args, int threads, size_t smem,
                         void* stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            substep_megakernel_kernel<MAX_BLOCK, kPerFlow>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    substep_megakernel_kernel<MAX_BLOCK, kPerFlow>
        <<<(unsigned)args->B, threads, smem, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

// the per-flow instantiation where either per-flow switch is set
template <int MAX_BLOCK>
static int launch_for(const SubstepArgs* args, int threads, size_t smem,
                      void* stream) {
    return (args->ext_decisions != nullptr || args->gc != 0)
        ? launch_blocks<MAX_BLOCK, true>(args, threads, smem, stream)
        : launch_blocks<MAX_BLOCK, false>(args, threads, smem, stream);
}

extern "C" int substep_megakernel(const SubstepArgs* args, void* stream) {
    if (args->M < 1 || args->M > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = layout_for(args->M, args->N, args->C, args->S,
                                   args->P, args->E).total;
    const int threads = (int)((args->M + 31) / 32 * 32);
    return threads <= SMALL_BLOCK
        ? launch_for<SMALL_BLOCK>(args, threads, smem, stream)
        : launch_for<MAX_THREADS>(args, threads, smem, stream);
}

extern "C" const char* substep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
