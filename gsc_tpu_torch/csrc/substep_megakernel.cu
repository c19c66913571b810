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
//     ("default" = id 0, "overhead" = id 1, compiled in), startup wait,
//     delayed release;
//  7. departures, the seven drop masks mapped to four reasons, counters.
//
// What bounds it on this card: neither bytes nor operations.  A substep
// touches a few tens of KB of one replica's state and does a few thousand
// operations; the interval is a chain of ~100 x 20 block-wide steps, each
// ending in __syncthreads, and the float reductions whose order decides an
// admission on a capacity boundary (the sorted cumulative sums, the
// scatter-adds into the rings) run in slot order on one thread.  So the
// kernel is latency-bound by that dependent chain.  The design answers
// with what removes launches and memory round trips: the flow table lives
// in shared memory for the whole interval, every substep of the interval
// runs inside one launch, and replicas run in parallel CTAs.  Making the
// serial parts parallel without changing float results is later work.
//
// Exactness: integer results are order-free (int atomics where used).
// Float sums are taken in the plain CPU version's order: scatter-adds in
// slot order (one owner thread per target, looping over slots), the
// admission cumulative sums sequentially in sorted order with a double
// accumulator rounded to f32 at each step (PyTorch's CPU cumsum does the
// same), and rounding half to even (rintf / __float2int_rn) where the
// plain version calls torch.round.  Build with -fmad=false: an FMA would
// round a*b+c once where the plain version rounds twice.  No float atomics
// are used, so two launches on the same inputs give identical bits.
// Out-of-range indices read as zero rows and scatter nowhere, as the
// plain version's gathers and scatters do; the kernel never reads outside
// a table.
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
#define MAX_THREADS 1024

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
    float* node_load; uint8_t* sf_available; const float* sf_startup;
    float* sf_last_active; const uint8_t* placed; const float* schedule;
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
};

// shared-memory arrays of M entries, in carve order
enum { I_PH, I_SFC, I_POS, I_ND, I_DST, I_HN, I_EG, I_CELL, I_SFNOW, I_EIDC,
       I_WRR, I_REQ, I_WANT, I_ADME, I_ADMN, I_ORDE, I_ORDN, I_ST, I_ADMS,
       I_RELE, I_RELN, I_FREE, N_IARR };
enum { F_DR, F_DUR, F_TTL, F_E2E, F_PP, F_TMR, F_HR, F_CAP, F_DEMS, F_DEM,
       F_SUM, F_CSE, F_VE, N_FARR };
#define N_COUNTERS 16

static size_t smem_bytes_for(long long M, long long P) {
    return (size_t)(N_IARR + N_FARR + 2 * P) * (size_t)M * 4
           + N_COUNTERS * 4 + 16;
}

__device__ __forceinline__ float resource_fn(int id, float load) {
    if (id == RF_OVERHEAD)
        return load > 0.0f ? __fadd_rn(1.0f, __fmul_rn(1.2f, load)) : 0.0f;
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

extern "C" __global__ void __launch_bounds__(MAX_THREADS)
substep_megakernel_kernel(SubstepArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const int M = (int)a.M, N = (int)a.N, C = (int)a.C, S = (int)a.S;
    const int P = (int)a.P, E = (int)a.E, H = (int)a.H, F = (int)a.F;
    const int K = (int)a.K, R = (int)a.R, ITERS = (int)a.iters;
    const int NP = N * P, NCS = N * C * S;
    const float dt = (float)a.dt;
    const bool own = tid < M;
    const int m = tid;

    int* ia[N_IARR];
    float* fa[N_FARR];
    {
        int* p = (int*)smem;
        for (int i = 0; i < N_IARR; ++i) { ia[i] = p; p += M; }
        float* q = (float*)p;
        for (int i = 0; i < N_FARR; ++i) { fa[i] = q; q += M; }
    }
    float* s_csn = fa[N_FARR - 1] + M;           // [M, P]
    float* s_vn = s_csn + (size_t)M * P;         // [M, P]
    int* cnt = (int*)(s_vn + (size_t)M * P);     // N_COUNTERS
    int *s_ph = ia[I_PH], *s_sfc = ia[I_SFC], *s_pos = ia[I_POS],
        *s_nd = ia[I_ND], *s_dst = ia[I_DST], *s_hn = ia[I_HN],
        *s_eg = ia[I_EG], *s_cell = ia[I_CELL], *s_sfnow = ia[I_SFNOW],
        *s_eidc = ia[I_EIDC], *s_wrr = ia[I_WRR], *s_req = ia[I_REQ],
        *s_want = ia[I_WANT], *s_adme = ia[I_ADME], *s_admn = ia[I_ADMN],
        *s_orde = ia[I_ORDE], *s_ordn = ia[I_ORDN], *s_st = ia[I_ST],
        *s_adms = ia[I_ADMS], *s_rele = ia[I_RELE], *s_reln = ia[I_RELN],
        *s_free = ia[I_FREE];
    float *s_dr = fa[F_DR], *s_dur = fa[F_DUR], *s_ttl = fa[F_TTL],
          *s_e2e = fa[F_E2E], *s_pp = fa[F_PP], *s_tmr = fa[F_TMR],
          *s_hr = fa[F_HR], *s_cap = fa[F_CAP], *s_dems = fa[F_DEMS],
          *s_dem = fa[F_DEM], *s_sum = fa[F_SUM], *s_cse = fa[F_CSE],
          *s_ve = fa[F_VE];
    __shared__ float s_t;

    // ---- per-replica views ----------------------------------------------
    const size_t fm = (size_t)b * M;
    float* node_load = a.node_load + (size_t)b * NP;
    uint8_t* sf_available = a.sf_available + (size_t)b * NP;
    const float* sf_startup = a.sf_startup + (size_t)b * NP;
    float* sf_last_active = a.sf_last_active + (size_t)b * NP;
    const uint8_t* placed = a.placed + (size_t)b * NP;
    const float* schedule = a.schedule + (size_t)b * NCS * N;
    float* edge_used = a.edge_used + (size_t)b * E;
    float* rel_node = a.rel_node + (size_t)b * H * NP;
    float* rel_edge = a.rel_edge + (size_t)b * H * E;
    int* drop_reasons = a.drop_reasons + (size_t)b * 4;
    int* run_dropped_per_node = a.run_dropped_per_node + (size_t)b * N;
    float* run_requested = a.run_requested + (size_t)b * NCS;
    float* run_requested_node = a.run_requested_node + (size_t)b * N;
    float* run_processed_traffic = a.run_processed_traffic + (size_t)b * NP;
    int* flow_counts = a.run_flow_counts + (size_t)b * NCS * N;
    float* run_max_node_usage = a.run_max_node_usage + (size_t)b * N;
    float* run_passed_traffic = a.run_passed_traffic + (size_t)b * E;
    const float* path_delay = a.path_delay + (size_t)b * a.topo_nn_stride;
    const int* next_hop = a.next_hop + (size_t)b * a.topo_nn_stride;
    const int* adj_edge_id = a.adj_edge_id + (size_t)b * a.topo_nn_stride;
    const float* edge_cap = a.edge_cap + (size_t)b * a.topo_e_stride;
    const float* edge_delay = a.edge_delay + (size_t)b * a.topo_e_stride;
    const size_t tro = (size_t)b * a.traf_stride;
    const float* arr_time = a.arr_time + tro;
    const int* arr_ingress = a.arr_ingress + tro;
    const float* arr_dr = a.arr_dr + tro;
    const float* arr_duration = a.arr_duration + tro;
    const float* arr_ttl = a.arr_ttl + tro;
    const int* arr_sfc = a.arr_sfc + tro;
    const int* arr_egress = a.arr_egress + tro;
    const float* cap_now = a.cap_now + (size_t)b * N;

    // ---- load the flow table into shared memory -------------------------
    if (own) {
        s_ph[m] = a.phase[fm + m];       s_sfc[m] = a.sfc[fm + m];
        s_pos[m] = a.position[fm + m];   s_nd[m] = a.node[fm + m];
        s_dst[m] = a.dest[fm + m];       s_hn[m] = a.hop_next[fm + m];
        s_eg[m] = a.egress[fm + m];      s_dr[m] = a.dr[fm + m];
        s_dur[m] = a.duration[fm + m];   s_ttl[m] = a.ttl[fm + m];
        s_e2e[m] = a.e2e[fm + m];        s_pp[m] = a.pend_path[fm + m];
        s_tmr[m] = a.timer[fm + m];
    }
    if (tid == 0) s_t = a.t[b];
    __syncthreads();

    for (int k = 0; k < K; ++k) {
        const float tt = s_t;
        const int g = __float2int_rn(__fdiv_rn(tt, dt));  // round half even
        int ridx = g % H;
        if (ridx < 0) ridx += H;
        if (tid < N_COUNTERS) cnt[tid] = 0;

        // ---- 1. capacity releases ----------------------------------------
        for (int i = tid; i < NP; i += nth) {
            float x = node_load[i] - rel_node[(size_t)ridx * NP + i];
            node_load[i] = x < 0.0f ? 0.0f : x;
            rel_node[(size_t)ridx * NP + i] = 0.0f;
        }
        for (int i = tid; i < E; i += nth) {
            float x = edge_used[i] - rel_edge[(size_t)ridx * E + i];
            edge_used[i] = x < 0.0f ? 0.0f : x;
            rel_edge[(size_t)ridx * E + i] = 0.0f;
        }
        __syncthreads();
        for (int i = tid; i < NP; i += nth)
            sf_available[i] = (sf_available[i] &&
                               (placed[i] || node_load[i] > EPS)) ? 1 : 0;

        // ---- 2. timers ---------------------------------------------------
        bool arrived = false, cont = false, depart_hop = false,
             need_a = false;
        if (own) {
            int ph = s_ph[m];
            float tmr = s_tmr[m];
            if (ph == PH_HOP || ph == PH_PROC) tmr = tmr - dt;
            bool proc_done = ph == PH_PROC && tmr <= EPS;
            bool hop_done = ph == PH_HOP && tmr <= EPS;
            int pos = s_pos[m] + (proc_done ? 1 : 0);
            if (proc_done) ph = PH_DECIDE;
            int nd = hop_done ? s_hn[m] : s_nd[m];
            arrived = hop_done && nd == s_dst[m];
            cont = hop_done && !arrived;
            float pc = arrived ? s_pp[m] : 0.0f;
            s_e2e[m] = s_e2e[m] + pc;
            s_ttl[m] = s_ttl[m] - pc;
            s_sum[m] = pc;
            int sfc = s_sfc[m];
            int cl = (sfc >= 0 && sfc < C) ? a.chain_len[sfc] : 0;
            depart_hop = arrived && pos >= cl;
            need_a = arrived && !(pos >= cl);
            s_ph[m] = ph; s_tmr[m] = tmr; s_pos[m] = pos; s_nd[m] = nd;
            if (arrived) atomicAdd(&cnt[0], 1);
        }
        __syncthreads();

        // ---- 3. arrivals (one thread: ranks over slots and candidates) ----
        if (tid == 0) {
            float path_add = 0.0f;
            for (int i = 0; i < M; ++i) path_add += s_sum[i];
            a.sum_path_delay[b] += path_add;
            a.num_path_delay[b] += cnt[0];
            a.run_path_delay_sum[b] += path_add;
            int nfree = 0;
            for (int i = 0; i < M; ++i)
                if (s_ph[i] == PH_FREE) s_free[nfree++] = i;
            const int cursor = a.cursor[b];
            int rank = 0, nsp = 0, nlate = 0;
            const float due_before = (tt + dt) - EPS;
            for (int c = 0; c < ARRIVALS_PER_SUBSTEP; ++c) {
                const int cand = cursor + c;
                const int cc = clampi(cand, 0, F - 1);
                const float at = arr_time[cc];
                if (!(at < due_before && cand < F && isfinite(at))) continue;
                const int r = rank++;
                if (r >= nfree) continue;
                const int sl = s_free[r];
                const int ing = arr_ingress[cc];
                const float drv = arr_dr[cc];
                s_ph[sl] = PH_DECIDE; s_nd[sl] = ing; s_pos[sl] = 0;
                s_sfc[sl] = arr_sfc[cc]; s_eg[sl] = arr_egress[cc];
                s_dst[sl] = -1; s_dr[sl] = drv;
                s_dur[sl] = arr_duration[cc]; s_ttl[sl] = arr_ttl[cc];
                s_e2e[sl] = 0.0f; s_pp[sl] = 0.0f;
                ++nsp;
                if (at < tt - EPS) ++nlate;
                if (ing >= 0 && ing < N)
                    run_requested_node[ing] = run_requested_node[ing] + drv;
            }
            a.cursor[b] = cursor + nsp;
            a.truncated[b] += nlate;
            a.generated[b] += nsp;
            a.run_generated[b] += nsp;
            a.active[b] += nsp;
        }
        __syncthreads();

        // ---- 4. decisions ------------------------------------------------
        bool drop_ttl0 = false, decide = false, to_eg = false, wrr = false;
        int cell = 0, sf_now = 0, rank = 0;
        if (own) {
            const int ph = s_ph[m], pos = s_pos[m], nd = s_nd[m];
            const int sfc = s_sfc[m];
            const float ttl = s_ttl[m];
            const int sfc_c = clampi(sfc, 0, C - 1);
            const int cl = (sfc >= 0 && sfc < C) ? a.chain_len[sfc] : 0;
            const bool to_eg_flag = pos >= cl;
            const bool deciding = ph == PH_DECIDE;
            drop_ttl0 = deciding && ttl <= EPS;
            decide = deciding && !drop_ttl0;
            to_eg = decide && to_eg_flag;
            if (to_eg && s_eg[m] < 0) s_eg[m] = nd;
            wrr = decide && !to_eg_flag;
            const int sf_pos = clampi(pos, 0, S - 1);
            sf_now = a.chain_sf[sfc_c * S + sf_pos];
            if (sf_now < 0) sf_now = 0;
            cell = (nd * C + sfc_c) * S + sf_pos;
            s_cell[m] = cell; s_wrr[m] = wrr ? 1 : 0; s_sfnow[m] = sf_now;
        }
        __syncthreads();
        // requested traffic of every WRR decision, slot order per cell
        for (int c = tid; c < NCS; c += nth) {
            float acc = 0.0f;
            bool any = false;
            for (int i = 0; i < M; ++i)
                if (s_wrr[i] && s_cell[i] == c) { acc = acc + s_dr[i]; any = true; }
            if (any) run_requested[c] = run_requested[c] + acc;
        }
        if (own && wrr)
            for (int i = 0; i < m; ++i) rank += (s_wrr[i] && s_cell[i] == cell);
        const bool cell_ok = cell >= 0 && cell < NCS;
        int dst = own ? s_dst[m] : 0;
        for (int r = 0; r < R; ++r) {
            const bool sel = own && wrr &&
                             (r < R - 1 ? rank == r : rank >= r);
            int choice = 0;
            if (sel) {
                int total = 0;
                if (cell_ok)
                    for (int j = 0; j < N; ++j)
                        total += flow_counts[(size_t)cell * N + j];
                float best = 0.0f;
                for (int j = 0; j < N; ++j) {
                    const int cntj = cell_ok ? flow_counts[(size_t)cell * N + j] : 0;
                    const float ratio = total > 0
                        ? __fdiv_rn((float)cntj, (float)(total > 1 ? total : 1))
                        : 0.0f;
                    const float p = cell_ok ? schedule[(size_t)cell * N + j] : 0.0f;
                    const float d = p > 0.0f ? p - ratio : -1.0f;
                    if (j == 0 || d > best) { best = d; choice = j; }
                }
                dst = choice;
            }
            __syncthreads();
            if (sel && cell_ok) atomicAdd(&flow_counts[(size_t)cell * N + choice], 1);
            __syncthreads();
        }

        // ---- 5. forwarding -----------------------------------------------
        bool drop_ttl_path = false, hop_req = false, start_path = false,
             depart_stay = false, drop_unplaced = false, want = false,
             drop_ttl_pd = false;
        float pd_path = 0.0f, hop_delay = 0.0f, pdel = 0.0f, pstart = 0.0f;
        int nh = 0, eid_c = 0, pos_e = 0, pos_n = 0;
        if (own) {
            if (to_eg) dst = s_eg[m];
            s_dst[m] = dst;
            const int nd = s_nd[m];
            float ttl = s_ttl[m];
            const bool stay = decide && dst == nd;
            depart_stay = to_eg && stay;
            const bool need_b = wrr && stay;
            start_path = decide && !stay;
            const int dc = dst < 0 ? 0 : dst;
            const bool nv = nd >= 0 && nd < N;
            const bool nn_ok = nv && dc < N;
            if (nn_ok) {
                const float pdv = path_delay[nd * N + dc];
                pd_path = isfinite(pdv) ? pdv : 1e30f;
            }
            s_cap[m] = nv ? cap_now[nd] : 0.0f;
            drop_ttl_path = start_path && (ttl - pd_path <= EPS);
            if (drop_ttl_path) ttl = 0.0f;
            start_path = start_path && !drop_ttl_path;
            hop_req = cont || start_path;
            nh = nn_ok ? next_hop[nd * N + dc] : 0;
            if (nh < 0) nh = 0;
            const int eid = (nv && nh < N) ? adj_edge_id[nd * N + nh] : 0;
            eid_c = eid < 0 ? 0 : eid;
            const bool ev = eid_c < E;
            s_hr[m] = ev ? (edge_cap[eid_c] - edge_used[eid_c]) + EPS : 0.0f;
            hop_delay = ev ? edge_delay[eid_c] : 0.0f;
            const bool need_proc = need_a || need_b;
            const bool sf_ok = nv && sf_now < P && placed[nd * P + sf_now];
            drop_unplaced = need_proc && !sf_ok;
            want = need_proc && sf_ok;
            float pmean = 0.0f, pstd = 0.0f;
            if (sf_now < P) {
                pmean = a.proc[sf_now * 3];
                pstd = a.proc[sf_now * 3 + 1];
                pstart = a.proc[sf_now * 3 + 2];
            }
            if (a.noise != nullptr) {
                const float z = a.noise[((size_t)b * K + k) * M + m];
                pdel = fabsf(__fadd_rn(__fmul_rn(z, pstd), pmean));
            } else {
                pdel = fabsf(pmean);
            }
            drop_ttl_pd = want && (ttl - pdel <= EPS);
            want = want && !drop_ttl_pd;
            s_ttl[m] = ttl;
            s_eidc[m] = eid_c;
            s_req[m] = (hop_req && eid >= 0) ? 1 : 0;
            s_want[m] = want ? 1 : 0;
        }
        __syncthreads();
        // group order: sorted position of (key, slot), keys made unique by
        // the slot, so the rank is a count
        if (own) {
            const int ke = s_eidc[m], kn = s_nd[m];
            for (int i = 0; i < M; ++i) {
                const int ei = s_eidc[i], ni = s_nd[i];
                pos_e += (ei < ke) || (ei == ke && i < m);
                pos_n += (ni < kn) || (ni == kn && i < m);
            }
            s_orde[pos_e] = m;
            s_ordn[pos_n] = m;
        }
        __syncthreads();
        // link admission: global cumsum in sorted order minus the run-start
        // prefix, admission_iters rounds, one thread (the float order is
        // the plain version's)
        if (tid == 0) {
            for (int p = 0; p < M; ++p) {
                const int i = s_orde[p];
                s_st[p] = (p == 0 || s_eidc[i] != s_eidc[s_orde[p - 1]])
                              ? p : s_st[p - 1];
                s_adms[p] = s_req[i];
            }
            for (int it = 0; it < ITERS; ++it) {
                double acc = 0.0;
                for (int p = 0; p < M; ++p) {
                    const float v = s_adms[p] ? s_dr[s_orde[p]] : 0.0f;
                    acc += (double)v;
                    s_cse[p] = (float)acc;
                    s_ve[p] = v;
                }
                for (int p = 0; p < M; ++p) {
                    const int i = s_orde[p], st = s_st[p];
                    s_adms[p] = s_req[i] &&
                        (s_cse[p] - (s_cse[st] - s_ve[st]) <= s_hr[i]);
                }
            }
        }
        __syncthreads();
        bool admitted = false;
        if (own) {
            admitted = s_adms[pos_e] != 0;
            s_adme[m] = admitted ? 1 : 0;
            s_rele[m] = -1;
            if (admitted) {
                const int h = ring_row(ridx, s_dur[m] + hop_delay, dt, H);
                const long long fi = (long long)h * E + eid_c;
                if (fi >= 0 && fi < (long long)H * E) s_rele[m] = (int)fi;
            }
        }
        __syncthreads();
        for (int e = tid; e < E; e += nth) {
            float acc = 0.0f;
            bool any = false;
            for (int i = 0; i < M; ++i)
                if (s_adme[i] && s_eidc[i] == e) { acc = acc + s_dr[i]; any = true; }
            if (any) {
                edge_used[e] = edge_used[e] + acc;
                run_passed_traffic[e] = run_passed_traffic[e] + acc;
            }
        }
        if (tid == 0)
            for (int i = 0; i < M; ++i)
                if (s_rele[i] >= 0)
                    rel_edge[s_rele[i]] = rel_edge[s_rele[i]] + s_dr[i];
        bool drop_link = false;
        if (own) {
            drop_link = hop_req && !admitted;
            if (admitted) {
                if (start_path) s_pp[m] = pd_path;
                s_hn[m] = nh;
                s_tmr[m] = hop_delay;
                s_ph[m] = PH_HOP;
            }
        // ---- 6. processing -----------------------------------------------
            float ttl = s_ttl[m];
            if (drop_ttl_pd) ttl = 0.0f;
            const float pw = want ? pdel : 0.0f;
            s_e2e[m] = s_e2e[m] + pw;
            s_ttl[m] = ttl - pw;
            s_sum[m] = pw;
            if (want) atomicAdd(&cnt[1], 1);
        }
        __syncthreads();
        if (tid == 0) {
            float s = 0.0f;
            for (int i = 0; i < M; ++i) s += s_sum[i];
            a.sum_proc_delay[b] += s;
            a.num_proc_delay[b] += cnt[1];
            // node admission through the resource functions, per SF column
            for (int p = 0; p < M; ++p) {
                const int i = s_ordn[p];
                s_st[p] = (p == 0 || s_nd[i] != s_nd[s_ordn[p - 1]])
                              ? p : s_st[p - 1];
                s_adms[p] = s_want[i];
                s_dems[p] = 0.0f;
            }
            for (int it = 0; it < ITERS; ++it) {
                for (int c = 0; c < P; ++c) {
                    double acc = 0.0;
                    for (int p = 0; p < M; ++p) {
                        const int i = s_ordn[p];
                        const float v = (s_adms[p] && s_sfnow[i] == c)
                                            ? s_dr[i] : 0.0f;
                        acc += (double)v;
                        s_csn[p * P + c] = (float)acc;
                        s_vn[p * P + c] = v;
                    }
                }
                for (int p = 0; p < M; ++p) {
                    const int i = s_ordn[p], st = s_st[p], nd = s_nd[i];
                    const bool nv = nd >= 0 && nd < N;
                    float dem = 0.0f;
                    for (int c = 0; c < P; ++c) {
                        const float base = nv ? node_load[nd * P + c] : 0.0f;
                        const bool av = nv && sf_available[nd * P + c];
                        const float lp = (base + s_csn[p * P + c])
                            - (s_csn[st * P + c] - s_vn[st * P + c]);
                        dem = dem + (av ? resource_fn(a.rf_id[c], lp) : 0.0f);
                    }
                    s_dems[p] = dem;
                    s_adms[p] = s_want[i] && dem <= s_cap[i] + EPS;
                }
            }
        }
        __syncthreads();
        bool admitted_n = false, drop_nodecap = false, drop_ttl_sw = false;
        if (own) {
            admitted_n = s_adms[pos_n] != 0;
            s_admn[m] = admitted_n ? 1 : 0;
            s_dem[m] = s_dems[pos_n];
            drop_nodecap = want && !admitted_n;
        }
        __syncthreads();
        for (int i = tid; i < NP; i += nth) {
            float acc = 0.0f;
            bool any = false;
            for (int j = 0; j < M; ++j) {
                const long long fi = (long long)s_nd[j] * P + s_sfnow[j];
                if (s_admn[j] && fi == i) { acc = acc + s_dr[j]; any = true; }
            }
            if (any) {
                node_load[i] = node_load[i] + acc;
                run_processed_traffic[i] = run_processed_traffic[i] + acc;
            }
        }
        for (int n = tid; n < N; n += nth) {
            float mx = 0.0f;
            for (int j = 0; j < M; ++j)
                if (s_nd[j] == n) {
                    const float v = s_admn[j] ? s_dem[j] : 0.0f;
                    mx = v > mx ? v : mx;
                }
            if (mx > run_max_node_usage[n]) run_max_node_usage[n] = mx;
        }
        if (own) {
            const int nd = s_nd[m];
            const bool nv = nd >= 0 && nd < N;
            float ttl = s_ttl[m];
            const float st_at = (nv && sf_now < P) ? sf_startup[nd * P + sf_now] : 0.0f;
            float sw = (st_at + pstart) - tt;
            if (sw < 0.0f) sw = 0.0f;
            drop_ttl_sw = admitted_n && (ttl - sw <= EPS) && sw > EPS;
            if (drop_ttl_sw) ttl = 0.0f;
            const bool started = admitted_n && !drop_ttl_sw;
            const float sws = started ? sw : 0.0f;
            s_e2e[m] = s_e2e[m] + sws;
            ttl = ttl - sws;
            s_ttl[m] = ttl;
            const float busy = started ? sw + pdel : 0.0f;
            if (started) { s_tmr[m] = busy; s_ph[m] = PH_PROC; }
            const float hold = started ? busy + s_dur[m] : dt;
            s_reln[m] = -1;
            if (started || drop_ttl_sw) {
                const int h = ring_row(ridx, hold, dt, H);
                const long long fi = (long long)h * NP + (long long)nd * P + sf_now;
                if (fi >= 0 && fi < (long long)H * NP) s_reln[m] = (int)fi;
            }
        // ---- 7. departures & drops ---------------------------------------
            const bool depart = depart_hop || depart_stay;
            s_sum[m] = depart ? s_e2e[m] : 0.0f;
            const bool ttl_out = ttl <= EPS;
            const bool masks[7] = {drop_ttl0, drop_ttl_path, drop_link,
                                   drop_unplaced, drop_ttl_pd, drop_nodecap,
                                   drop_ttl_sw};
            const int reasons[7] = {DROP_DECISION, DROP_LINK_CAP,
                                    DROP_LINK_CAP, DROP_NODE_CAP,
                                    DROP_NODE_CAP, DROP_NODE_CAP,
                                    DROP_NODE_CAP};
            bool any_drop = false;
            for (int q = 0; q < 7; ++q) {
                if (!masks[q]) continue;
                any_drop = true;
                atomicAdd(&cnt[4 + (ttl_out ? DROP_TTL : reasons[q])], 1);
            }
            if (depart) atomicAdd(&cnt[2], 1);
            if (any_drop) {
                atomicAdd(&cnt[3], 1);
                if (nv) atomicAdd(&run_dropped_per_node[nd], 1);
            }
            if (depart || any_drop) s_ph[m] = PH_FREE;
        }
        __syncthreads();
        if (tid == 0) {
            for (int i = 0; i < M; ++i)
                if (s_reln[i] >= 0)
                    rel_node[s_reln[i]] = rel_node[s_reln[i]] + s_dr[i];
            float dep_sum = 0.0f, dep_max = 0.0f;
            for (int i = 0; i < M; ++i) {
                dep_sum += s_sum[i];
                dep_max = s_sum[i] > dep_max ? s_sum[i] : dep_max;
            }
            const int n_dep = cnt[2], n_drop = cnt[3];
            a.processed[b] += n_dep;
            a.run_processed[b] += n_dep;
            a.sum_e2e[b] += dep_sum;
            a.run_e2e_sum[b] += dep_sum;
            if (dep_max > a.run_e2e_max[b]) a.run_e2e_max[b] = dep_max;
            for (int q = 0; q < 4; ++q) drop_reasons[q] += cnt[4 + q];
            a.dropped[b] += n_drop;
            a.run_dropped[b] += n_drop;
            a.active[b] -= n_dep + n_drop;
            s_t = tt + dt;
        }
        for (int i = tid; i < NP; i += nth)
            if (node_load[i] > EPS) sf_last_active[i] = tt;
        __syncthreads();
    }

    // ---- store the flow table and the clock ------------------------------
    if (own) {
        a.phase[fm + m] = s_ph[m];       a.sfc[fm + m] = s_sfc[m];
        a.position[fm + m] = s_pos[m];   a.node[fm + m] = s_nd[m];
        a.dest[fm + m] = s_dst[m];       a.hop_next[fm + m] = s_hn[m];
        a.egress[fm + m] = s_eg[m];      a.dr[fm + m] = s_dr[m];
        a.duration[fm + m] = s_dur[m];   a.ttl[fm + m] = s_ttl[m];
        a.e2e[fm + m] = s_e2e[m];        a.pend_path[fm + m] = s_pp[m];
        a.timer[fm + m] = s_tmr[m];
    }
    if (tid == 0) a.t[b] = s_t;
}

extern "C" long long substep_args_size() {
    return (long long)sizeof(SubstepArgs);
}

extern "C" long long substep_smem_bytes(long long M, long long P) {
    return (long long)smem_bytes_for(M, P);
}

extern "C" int substep_megakernel(const SubstepArgs* args, void* stream) {
    if (args->M < 1 || args->M > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes_for(args->M, args->P);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            substep_megakernel_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int threads = (int)((args->M + 31) / 32 * 32);
    substep_megakernel_kernel<<<(unsigned)args->B, threads, smem,
                                (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" const char* substep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
