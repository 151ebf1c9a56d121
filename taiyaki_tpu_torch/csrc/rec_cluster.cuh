// The cluster instance of the forward recurrences (lstm.cu, gru.cu): the
// machinery the LSTM and GRU kernels share.
//
// Design.  A thread-block cluster of C CTAs walks one tile of BT batch
// rows through all T steps.  CTA rank q owns the hidden units
// [q U, min(H, (q + 1) U)), U = ceil(H / C) (the last rank's slice may be
// ragged: its units past H are masked).  At kernel start it copies its
// slice of sW^T into shared memory, every gate of each owned unit over all
// H inputs, and never reads sW again.  Shared memory of a CTA:
//     bar[2]              (one mbarrier per h buffer)        16 bytes
//     wS[k][u][4]         (float4 of the gates of unit u at input k; a
//                          GRU's fourth lane is zero)        16 H U bytes
//     hS[2][C U][BT]      (h of the tile, double-buffered;
//                          rank q's block at q U BT)         8 C U BT bytes
//     ring[2][BT][U][4]   (the input gates of this step and
//                          the next)                         32 BT U bytes
//     part[KS][BT][U][4]  (the product's partial sums)       16 KS BT U bytes
// rec_cluster_smem below and ops/rnn_plan.py `cluster_smem` compute the
// same sum; the plan takes this instance wherever it fits in 232,448 bytes
// with C <= 16.  The launch reserves at least REC_ONE_PER_SM bytes, so that
// no two CTAs share an SM.
//
// A step has two phases.
//  1. The product.  Warp w takes k slice w % KS (H / KS inputs), unit
//     group (w / KS) % nug (32 units, one a lane; nug = ceil(U / 32)) and
//     row group w / (KS nug) (RB rows; BT / RB groups).  A lane keeps the G
//     gate sums of its unit for its RB rows in registers (G RB of them);
//     per input k it loads one float4 of wS (32 distinct units a warp: no
//     lane's load is wasted) and RB values of hS that all lanes of the warp
//     share (broadcast), and issues G RB fmaf.  Each lane then writes its
//     partial sums to part[ks].  The KS slices put KS times the warps on
//     the same shared-memory traffic, to hide its latency.
//  2. The cells, after a __syncthreads.  Each thread takes at most 4
//     cells (unit, row) of the tile, fixed for the launch: it adds the KS
//     partial sums in slice order onto the input gates (the LSTM) or alone
//     (the GRU's gh), applies the cell, keeps c (the LSTM) in registers,
//     writes h to its own CTA's hS and its outputs to device memory.
// The sum over k runs in KS slices, each an fmaf chain from zero: the
// outputs differ from the L2 instance's (one chain from gx) in the last
// bits (at most 1e-5 on the card at the repo's shapes); run to run they
// are the same.
//
// Cost of one step on one SM, in cycles (nw = KS nug BT / RB warps;
// shared memory delivers 32 floats a cycle to the registers); ops/
// rnn_plan.py `step_cycles` holds the model and its constants, measured
// with probes/rec_phases.cu:
//  (a) the product's instruction issue: (H / KS) (G RB + 1 + RB)
//      ceil(nw / 4) (one warp instruction a cycle on each of the 4
//      sub-partitions);
//  (b) its shared-memory reads: nw (H / KS) (4 + RB) (the float4 of wS
//      takes 4 cycles a warp, each broadcast value of hS one);
//      the product takes the larger of (a), (b) and its latency (24 + RB
//      cycles an input of a warp), plus half the smaller of (a) and (b);
//  (c) the exchange: the proxy fence and barrier, C - 1 bulk copies and
//      the wait for the slowest rank, ~150 + 100 C;
//  (d) the cells: ~1150 cycles an LSTM cell, ~950 a GRU cell, times the
//      cells of a thread, on the step's serial path;
// plus the step's top (the gate copies, ~450) and its __syncthreads.  The
// plan picks C, BT, RB and KS with this model, after the fewest waves
// and the most SMs busy.
//
// The DSMEM and mbarrier protocol, step s (time t = s, or T-1-s reversed;
// b = (s+1) & 1 the buffer that step s fills):
//  - At the top of step s, thread 0 arrives on bar[b] expecting (C - 1) U
//    BT 4 bytes (the other ranks' blocks of h), and each thread issues the
//    cp.async copies of step s+1's input gates for its own cells into
//    ring[b].  It waits for its copies of step s only in phase 2
//    (cp.async.wait_group 1): a thread reads only the ring words it copied
//    itself, so the wait needs no barrier, and the copies run during the
//    product.
//  - The product reads hS[s & 1] of its own CTA only.
//  - Each cell's new h goes into hS[b] of its own CTA, in the rank's block.
//    Each thread then orders its stores before the async proxy
//    (fence.proxy.async), a __syncthreads follows, and thread p (p < C,
//    p != q) sends the whole block to the same place in rank p's hS[b] by
//    one cp.async.bulk shared::cta -> shared::cluster copy, completing its
//    bytes on rank p's bar[b].  Every thread waits for bar[b]'s phase
//    (s >> 1) & 1 to complete (acquire, cluster scope): all C blocks are
//    in place.  No cluster barrier runs inside the loop.
//  - Why it is safe: a rank writes its block into hS[b] of the others
//    during step s; they last read hS[b] in their product of step s-1,
//    and the writer could only start step s once it held every rank's
//    block of step s-1, which each rank sends after its step s-1 product
//    (the product's loads feed the values sent).  The same holds for the
//    block's source: a rank rewrites its own block of hS[b] at step s+2,
//    after its step s+1 wait, which needs the others' blocks of step s+1,
//    sent only once they held (read in full) its block of step s.  part is
//    rewritten at step s+1 only after the step's wait, which needs this
//    CTA's own block, written after every cell read part.  Nothing reaches
//    bar[b] for step s+2 before this step's phase completes.  A remote
//    completion may come before thread 0's arrive: the transaction count
//    goes below zero until the arrive, and the phase cannot complete while
//    the arrival pends.
//  - Step T-1 exchanges nothing (no later step reads it).
//  - Before the loop: the mbarriers are initialised (fence.mbarrier_init
//    at cluster scope), hS[0] is zeroed (the initial state), the weights
//    and step 0's gates are copied, and a cluster barrier makes sure every
//    CTA of the cluster has started and done this before any remote copy
//    reaches it.  After the loop: a final cluster barrier, so that no CTA
//    exits while another could still access its shared memory.
//
// Launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension (C,
// 1, 1), grid C * ceil(B / BT); clusters of more than 8 need
// cudaFuncAttributeNonPortableClusterSizeAllowed.  Before launching,
// cudaOccupancyMaxActiveClusters must find room for at least one cluster
// of the plan; otherwise, or if the launch is refused, the error is
// returned (and the wrapper raises).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int REC_SMEM_LIMIT = 232448;   // dynamic shared memory of a CTA
constexpr int REC_ONE_PER_SM = 118784;   // over half an SM's 228 KB
constexpr int REC_MAX_CLUSTER = 16;      // non-portable cluster size limit
constexpr int REC_CLUSTER_THREADS = 512;
constexpr int REC_MAX_BT = 32;           // rows a tile
constexpr int REC_MAX_CELLS = 4;         // cells a thread

// the two instances of a forward recurrence (tt_lstm_fwd's and
// tt_gru_fwd's `instance`), as ops/rnn_plan.py numbers them
constexpr int INSTANCE_L2 = 0;
constexpr int INSTANCE_CLUSTER = 1;

// bytes of shared memory of one CTA of C ranks: mbarriers, sW^T slice, h
// buffers (C U units), gate ring, partial sums
inline size_t rec_cluster_smem(int H, int C, int U, int BT, int KS)
{
    return 16 + 16 * (size_t)H * U + 8 * (size_t)C * U * BT
           + 32 * (size_t)BT * U + 16 * (size_t)KS * BT * U;
}

// the rows a lane in the product the kernels are instantiated for
// (ops/rnn_plan.py ROWS_A_LANE: the values the plans of the repo's shapes
// take, and 1)
__host__ __device__ constexpr bool rec_rows_a_lane(int RB)
{
    return RB == 1 || RB == 2 || RB == 4 || RB == 5 || RB == 6 || RB == 9;
}

// threads of a CTA: a warp per k slice, unit group and row group
inline int rec_cluster_threads(int U, int BT, int RB, int KS)
{
    return 32 * KS * ((U + 31) / 32) * (BT / RB);
}

// Checks a plan (C ranks, BT rows a tile, RB rows a lane, KS k slices)
// for H units: cudaSuccess, or cudaErrorInvalidValue for one this
// instance cannot take.  `smem` must be the plan's byte count as
// rec_cluster_smem gives it.
inline cudaError_t rec_cluster_check(int H, int C, int BT, int RB, int KS,
                                     int smem)
{
    if (C < 1 || C > REC_MAX_CLUSTER || H < 1 || !rec_rows_a_lane(RB)
            || BT < RB || BT > REC_MAX_BT || BT % RB != 0 || KS < 1
            || KS > H)
        return cudaErrorInvalidValue;
    const int U = (H + C - 1) / C;
    const int threads = rec_cluster_threads(U, BT, RB, KS);
    // every rank owns at least one unit; at most REC_MAX_CELLS cells a
    // thread; a rank's h block a multiple of 16 bytes (the bulk copy)
    if ((H + U - 1) / U != C || threads > REC_CLUSTER_THREADS
            || U * BT > REC_MAX_CELLS * threads || U * BT % 4 != 0)
        return cudaErrorInvalidValue;
    const size_t need = rec_cluster_smem(H, C, U, BT, KS);
    if (need > (size_t)REC_SMEM_LIMIT || need != (size_t)smem)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// Checks a launch plan before any work is queued: the L2 instance takes
// C = 1, its own tile of l2_bt rows (RB and KS 1) and 8 H l2_bt bytes,
// for H up to l2_max_h; the cluster instance what rec_cluster_check takes.
inline cudaError_t rec_plan_check(int instance, int H, int C, int BT, int RB,
                                  int KS, int smem, int l2_bt, int l2_max_h)
{
    if (instance == INSTANCE_L2)
        return H <= l2_max_h && C == 1 && BT == l2_bt && RB == 1 && KS == 1
                       && smem == 8 * H * l2_bt
                   ? cudaSuccess : cudaErrorInvalidValue;
    if (instance == INSTANCE_CLUSTER)
        return rec_cluster_check(H, C, BT, RB, KS, smem);
    return cudaErrorInvalidValue;
}

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank()
{
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_id()
{
    uint32_t r;
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync()
{
    cluster_arrive();
    cluster_wait();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of CTA-local address `a` in rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank)
{
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

// 4-byte asynchronous copy to shared memory; zero-fills when !pred
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool pred)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}


// the mbarrier at `bar` expects one arrival a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(bar)) : "memory");
}

// makes the initialised mbarriers visible to the cluster's async stores
__device__ __forceinline__ void mbar_init_fence()
{
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this phase's arrival, expecting `bytes` more to complete on `bar`
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes)
{
    uint64_t state;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
                 : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
    (void)state;
}

// waits for the phase of parity `parity` of `bar` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    const uint32_t a = smem_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
            "p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

// makes this thread's shared-memory stores visible to the async proxy
// (the bulk copies)
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from this CTA's shared memory at `src` to the
// shared::cluster address `dst`, completing on the mbarrier at
// shared::cluster address `bar` (of the destination CTA)
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src,
                                                  uint32_t bytes,
                                                  uint32_t bar)
{
    asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// -- the steps' building blocks ----------------------------------------------

// The shared memory of a CTA, cut as the design above lays it out.
struct RecSmem {
    uint64_t* bar;   // [2]
    float* wS;       // [H][U][4]
    float* hS;       // [2][C U][BT]
    float* ring;     // [2][BT][U][4]
    float* part;     // [KS][BT][U][4]
};

__device__ __forceinline__ RecSmem rec_smem(float* smem, int H, int C,
                                            int U, int BT)
{
    RecSmem m;
    m.bar = reinterpret_cast<uint64_t*>(smem);
    m.wS = smem + 4;
    m.hS = m.wS + (size_t)H * U * 4;
    m.ring = m.hS + 2 * C * U * BT;
    m.part = m.ring + 2 * BT * U * 4;
    return m;
}

// A thread's share of the product: its k slice [k0, k1), its unit within
// the rank (ul_c, one a lane) and its row group rg (rows rg RB ..).
struct RecWork {
    int k0, k1, ks, ul_c, rg;
};

__device__ __forceinline__ RecWork rec_work(int H, int U, int KS)
{
    const int nug = (U + 31) / 32;
    const int w = threadIdx.x >> 5;
    const int ks = w % KS;
    const int hk = (H + KS - 1) / KS;
    return {ks * hk, min(H, (ks + 1) * hk), ks,
            (w / KS) % nug * 32 + (int)(threadIdx.x & 31), w / KS / nug};
}

// This CTA's slice of sW^T [H, G H] into wS[k][u][4]: gate g of unit
// u0 + u at input k; zero where g >= G or the unit is past H.
template <int G>
__device__ __forceinline__ void rec_load_weights(float* wS,
                                                 const float* __restrict__ swt,
                                                 int H, int U, int u0)
{
    const int n = H * U * 4;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int g = i & 3;
        const int u = (i >> 2) % U;
        const int k = (i >> 2) / U;
        const bool ok = g < G && u0 + u < H;
        cp_async4(wS + i, ok ? swt + (size_t)k * G * H + g * H + u0 + u
                             : swt, ok);
    }
}

// A thread's cells: (unit u0 + u_c, row of the tile) for the indices i =
// threadIdx.x + j blockDim.x with u_c = i % U, row = i / U, units past H
// left out; fixed for the whole launch.
struct RecCells {
    int n;
    int u_c[REC_MAX_CELLS];
    int row[REC_MAX_CELLS];
};

__device__ __forceinline__ RecCells rec_cells(int H, int U, int BT, int u0)
{
    RecCells cl;
    cl.n = 0;
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        cl.u_c[j] = i % U;
        cl.row[j] = i / U;
        if (cl.row[j] < BT && u0 + cl.u_c[j] < H) cl.n = j + 1;
    }
    return cl;
}

// The input gates of time t of this thread's cells into ring slot
// [BT][U][4]: a thread copies what it reads itself.  Rows past B are left
// alone (the cell reads zero).
template <int G>
__device__ __forceinline__ void rec_prefetch(float* slot,
                                             const float* __restrict__ gx,
                                             int t, int B, int b0, int nrow,
                                             int H, int U, int u0,
                                             const RecCells& cl)
{
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
            const float* g = gx + ((size_t)t * B + b0 + cl.row[j]) * G * H
                             + u0 + cl.u_c[j];
            float* d = slot + ((size_t)cl.row[j] * U + cl.u_c[j]) * 4;
#pragma unroll
            for (int q = 0; q < G; ++q) cp_async4(d + q, g + q * H, true);
        }
    }
}

// acc[q][r] = fmaf chain over k = k0 .. k1-1 of wS[k][ul_c].q *
// hS[k][rg RB + r], from zero.
template <int G, int RB>
__device__ __forceinline__ void rec_product(const float4* __restrict__ wS,
                                            const float* __restrict__ hc,
                                            const RecWork& wk, int U, int BT,
                                            float (&acc)[4][RB])
{
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q][r] = 0.f;
    const float4* w = wS + wk.ul_c;
    const float* hp = hc + wk.rg * RB;
#pragma unroll 4
    for (int k = wk.k0; k < wk.k1; ++k) {
        const float4 wv = w[(size_t)k * U];
        const float* hk = hp + k * BT;
        float hv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) hv[r] = hk[r];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            acc[0][r] = fmaf(wv.x, hv[r], acc[0][r]);
            acc[1][r] = fmaf(wv.y, hv[r], acc[1][r]);
            acc[2][r] = fmaf(wv.z, hv[r], acc[2][r]);
            if constexpr (G == 4) acc[3][r] = fmaf(wv.w, hv[r], acc[3][r]);
        }
    }
}

// The product phase of a step: this thread's partial sums into
// part[ks][row][ul_c].
template <int G, int RB>
__device__ __forceinline__ void rec_partials(const RecSmem& m,
                                             const float* hc,
                                             const RecWork& wk, int U,
                                             int BT)
{
    float acc[4][RB];
    rec_product<G, RB>(reinterpret_cast<const float4*>(m.wS), hc, wk, U, BT,
                       acc);
    float4* p = reinterpret_cast<float4*>(m.part)
                + ((size_t)wk.ks * BT + wk.rg * RB) * U + wk.ul_c;
#pragma unroll
    for (int r = 0; r < RB; ++r)
        p[(size_t)r * U] = make_float4(acc[0][r], acc[1][r], acc[2][r],
                                       acc[3][r]);
}

// The recurrent product of cell (u_c, row): the KS partial sums added in
// slice order onto `v`.
__device__ __forceinline__ float4 rec_sum(const RecSmem& m, float4 v,
                                          int KS, int U, int BT, int u_c,
                                          int row)
{
    const float4* p = reinterpret_cast<const float4*>(m.part)
                      + (size_t)row * U + u_c;
    // unrolled so that the loads of several slices are in flight at once
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
        const float4 q = p[(size_t)ks * BT * U];
        v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
    }
    return v;
}

// The end of step s's cells: this rank's block of h (units u0 .. u0+U-1,
// all BT rows, in hS[b]) to the same place in every other rank, by one
// bulk copy each, completing on that rank's bar[b].  Every thread first
// makes its own stores to the block visible to the copy (async proxy).
__device__ __forceinline__ void rec_send(const RecSmem& m, int nb, int C,
                                         int U, int BT, int u0)
{
    fence_proxy_async();
    __syncthreads();
    const int q = threadIdx.x;
    const uint32_t rank = cluster_rank();
    if (q < C && q != (int)rank) {
        const uint32_t src = smem_addr(m.hS + (size_t)(nb * C * U + u0) * BT);
        bulk_copy_cluster(map_rank(src, q), src, 4 * U * BT,
                          map_rank(smem_addr(m.bar + nb), q));
    }
}

// The start of the kernel: mbarriers, weights, h = 0, step 0's gates, and
// the cluster barrier after which remote stores may come.
template <int G>
__device__ __forceinline__ void rec_prologue(const RecSmem& m,
                                             const float* __restrict__ gx,
                                             const float* __restrict__ swt,
                                             int t0, int B, int b0, int nrow,
                                             int H, int C, int U, int u0,
                                             int BT, const RecCells& cl)
{
    if (threadIdx.x == 0) {
        mbar_init(m.bar);
        mbar_init(m.bar + 1);
        mbar_init_fence();
    }
    rec_load_weights<G>(m.wS, swt, H, U, u0);
    for (int i = threadIdx.x; i < C * U * BT; i += blockDim.x) m.hS[i] = 0.f;
    rec_prefetch<G>(m.ring, gx, t0, B, b0, nrow, H, U, u0, cl);
    cp_async_commit();
    cp_async_wait<0>();
    cluster_sync();
}

// The top of step s: thread 0's arrival on the buffer the step fills (the
// other C-1 ranks' blocks to come), and the copies of step s+1's gates
// (time tn) into the other ring slot.
template <int G>
__device__ __forceinline__ void rec_step_top(const RecSmem& m,
                                             const float* __restrict__ gx,
                                             int s, int T, int tn, int B,
                                             int b0, int nrow, int H, int C,
                                             int U, int u0, int BT,
                                             const RecCells& cl)
{
    const int nb = (s + 1) & 1;
    if (s + 1 < T) {
        if (threadIdx.x == 0)
            mbar_arrive_expect(m.bar + nb, 4 * (C - 1) * U * BT);
        rec_prefetch<G>(m.ring + nb * BT * U * 4, gx, tn, B, b0, nrow, H, U,
                        u0, cl);
    }
    cp_async_commit();
}

// The phase clock of a step, for probes/rec_phases.cu: RecClock<true>
// sums, on each thread, the clock64 cycles of the step's phases (REC_TOP
// the gate copies, REC_PRODUCT the product and its barrier, REC_CELLS,
// REC_SEND, REC_WAIT the wait for the step's h) over the steps, and thread
// 0 stores them at out[REC_PHASES blockIdx.x ..].  RecClock<false>, the
// kernels' own, is empty and compiles to nothing.
constexpr int REC_TOP = 0, REC_PRODUCT = 1, REC_CELLS = 2, REC_SEND = 3,
              REC_WAIT = 4, REC_PHASES = 5;

template <bool ON>
struct RecClock {
    __device__ __forceinline__ void start() {}
    template <int PHASE>
    __device__ __forceinline__ void lap() {}
    __device__ __forceinline__ void store(long long*) {}
};

template <>
struct RecClock<true> {
    long long sum[REC_PHASES] = {0, 0, 0, 0, 0};
    long long last = 0;
    __device__ __forceinline__ void start() { last = clock64(); }
    template <int PHASE>
    __device__ __forceinline__ void lap()
    {
        const long long now = clock64();
        sum[PHASE] += now - last;
        last = now;
    }
    __device__ __forceinline__ void store(long long* out)
    {
        if (threadIdx.x == 0)
            for (int i = 0; i < REC_PHASES; ++i)
                out[blockIdx.x * REC_PHASES + i] = sum[i];
    }
};

// `f(std::integral_constant<int, RB>{})` for the runtime RB (rows a lane)
// of a checked plan: the kernels are instantiated for the RB that
// rec_rows_a_lane takes.
template <typename F>
int rec_with_rb(int RB, F&& f)
{
    switch (RB) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 9: return f(std::integral_constant<int, 9>{});
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of `kernel` as clusters of C CTAs (grid
// blocks), one CTA an SM: its shared memory reserved as at least
// REC_ONE_PER_SM bytes, clusters of more than 8 allowed.  `attr` holds the
// cluster dimension the configuration points to.
template <typename... KArgs>
cudaError_t rec_cluster_config(void (*kernel)(KArgs...), int C, int blocks,
                               int threads, int smem, cudaStream_t st,
                               cudaLaunchAttribute* attr,
                               cudaLaunchConfig_t* cfg)
{
    const int reserve = smem > REC_ONE_PER_SM ? smem : REC_ONE_PER_SM;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, reserve);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(blocks);
    cfg->blockDim = dim3(threads);
    cfg->dynamicSmemBytes = reserve;
    cfg->stream = st;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return err;
}

// Launches `kernel` as clusters of C CTAs over ntiles batch tiles, after
// checking that at least one cluster of the plan fits on the card.
template <typename... KArgs, typename... Args>
int rec_cluster_launch(void (*kernel)(KArgs...), int C, int ntiles,
                       int threads, int smem, cudaStream_t st,
                       Args... args)
{
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t err = rec_cluster_config(kernel, C, C * ntiles, threads,
                                         smem, st, &attr, &cfg);
    int nclusters = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&nclusters, (const void*)kernel,
                                             &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nclusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters for `kernel` under a plan, configured as
// rec_cluster_launch configures it: how many of its clusters the card runs
// at once (0 if none fits), or minus the CUDA error.
template <typename... KArgs>
int rec_cluster_occupancy(void (*kernel)(KArgs...), int C, int threads,
                          int smem)
{
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t err = rec_cluster_config(kernel, C, C, threads, smem,
                                         nullptr, &attr, &cfg);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace
