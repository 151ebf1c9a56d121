// The cluster instances of the recurrences (lstm.cu, gru.cu), forward and
// backward chain: the machinery the LSTM and GRU kernels share.  The
// backward's layout and protocol follow the forward's description.
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
//  - A bf16 gate stream (the forwards' bf16 instances on given gates,
//    GX16) does not go by this per-cell copy: cp.async copies 4 bytes at
//    least, and a thread's gates of a cell lie H apart.  Each thread loads
//    step s+1's gates of its cells into registers at the top of step s
//    (rec_step_top), before the product, and stores them widened to its
//    ring slot after it (rec_stash_gates); a thread still reads only the
//    ring words it wrote itself.  (The backward chains' bf16 instances
//    copy their 2-byte words by cp.async after all, through a word-major
//    ring whose runs are U units long: "The bf16 chains' ring" below.)
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
//
// The backward chains' cluster instance (lstm.cu and gru.cu kernel 3a)
// walks the same tiles the other way in time, rank q owning the same
// units.  Its product runs the other way too: dh_prev[k] = sum over the G
// gates g and units j of dgate[g][j] sW[g H + j][k].  Rank q sums only
// over its own G U gate rows, so its product is a *partial* dh_prev over
// all H units of the tile; the C partials of a unit are summed by the
// rank that owns it (a reduce-scatter).  Shared memory of a CTA:
//     bar[2]              (one mbarrier per receive buffer)  16 bytes
//     dS[BT][U][4]        (this step's gate gradients of the
//                          own cells; a GRU's fourth is 0)   16 BT U bytes
//     recv[2][C][U][BT]   (the other ranks' partials of the
//                          own units, rank r's at r U BT)    8 C U BT bytes
//     part[2][C U][BT]    (this rank's partial over all
//                          units; block p goes to rank p)    8 C U BT bytes
//     wS[U][G][H]         (the own gate rows of sW: row
//                          g H + u0 + u at [u][g])           4 G H U bytes
//     ring[BT][U][R]      (step s+1's inputs of the own
//                          cells, R = 7 LSTM, 8 GRU words;
//                          the bf16 instances' [R][BT][U],
//                          below)                            4 R BT U bytes
// rec_bwd_smem below and ops/rnn_plan.py `bwd_smem` compute the same sum
// (230,160 bytes for the LSTM at H = 256, C = 8, BT = 18; 199,696 for the
// GRU, whose three gate rows are not padded to four), for both instances.
// A step s (time t = T-1-s, or s for a reversed layer):
//  1. The cells: each thread waits for its own ring copies, sums its
//     cells' C partials of step s-1 in rank order (its own block from
//     part, the others from recv) onto dh, applies the cell's backward,
//     keeps the carried dc (LSTM) or dh z (GRU) and the d_b sums in
//     registers, stores the gate gradients to device memory and to dS.
//  2. __syncthreads, then each thread copies step s+1's inputs of its
//     cells into the ring (cp.async; it read its words of step s in 1; the
//     bf16 instances: its share of the whole ring's copies, waited for
//     before the send's barrier, below) and
//     the product runs: with nkg = ceil(H / (32 KL)), warp w takes the KL
//     output units (w % nkg) 32 KL + lane + 32 i (i < KL) and row group
//     w / nkg (RB rows); per own unit u it loads the KL G weights of its
//     lane (consecutive lanes, consecutive words) and RB float4 of dS
//     (broadcast), and issues KL G RB fmaf, the sum over u and g one
//     chain an output, from zero.  Its KL RB sums go to part[b][k][rows]
//     (b = (s+1) & 1).  Two units a lane (KL = 2) halve the broadcasts a
//     fmaf: the shared-memory reads, not the fmaf, bound the product.
//  3. The exchange, as the forward's: fence.proxy.async, __syncthreads,
//     thread p sends block p of part[b] to recv[b][q] of rank p by one
//     bulk copy completing on rank p's bar[b]; every thread waits for
//     bar[b]'s phase (s >> 1) & 1.
// Why the buffers are safe: recv[b] of rank q is written by rank r at
// step s only after r's step s-1 wait, which needs q's step s-1 send,
// which q issues after its step s-1 cells, the last reads of recv[b]
// (recv[b] is read at steps s-1 and s+1).  part[b] is rewritten at step
// s+2, after q's step s+1 wait, which needs every other rank's step s+1
// send, issued after that rank's step s wait, which needed q's step s
// blocks (read out of part[b]) in full.  dS is rewritten at step s+1's
// cells, after step s's send barrier, which follows the product.  The
// GRU's in-place case (the gate streams' gradients written over the
// streams): step s+1's ring copies read time row t -/+ 1, never row t,
// the only row step s writes, and each thread reads a row's inputs (step
// s-1's copies, waited for) before it stores to that row.  The sum over
// the own units is not split (a plan's KS field carries KL instead).
// After the loop a cluster barrier; then the ring holds the cells' d_b
// and each (unit, gate) of the tile is summed over the rows in order into
// db_part[tile].
//
// The bf16 chains' ring.  A bf16 word is 2 bytes and cp.async copies 4 at
// least, and a cell's words lie H units apart in device memory, so the
// per-cell ring above cannot take them.  The bf16 instances lay the ring
// out word-major instead, [R][BT][U], each word in its stream's own type
// (2 bytes a unit for bf16, 4 for f32: the recompute's rebuilt gates, an
// f32 dh or h_prev) in a region of 4 BT U bytes (the f32 ring's bytes, so
// rec_bwd_smem holds for both).  A word of tile row r is then the rank's U
// units, one run of U es bytes both in device memory and in shared
// memory, and a step's inputs are one list of (word, row, chunk) copies
// that the CTA's threads share (rec_ring_word):
//  - copy i of a word (i < nrow per, per = U es / W chunks a run) is tile
//    row i / per, bytes (i % per) W of its run; thread x takes copies x,
//    x + nt, ... of the words' lists laid end to end;
//  - W is the widest cp.async (16 bytes by .cg, else 8 or 4 by .ca) that
//    divides a stream row's H es bytes, the run's U es and the ring's
//    address (rec_ring_width; every stream's base is aligned to it), the
//    same for all words of one size (rec_ring_geo): for bf16 words, 16 at
//    every plan of H = 256 and 384 and at H = 16 and 96 with C = 2 (U = 8,
//    48), 8 at H = 16 with C = 4 (U = 4) and H = 96 with C = 8 (U = 12), 4
//    at H = 100 (C = 2, U = 50); a ragged last rank (H % C != 0) copies on
//    its cluster's width (H = 124, C = 16: U = 8, 8 bytes; H = 30, C = 4:
//    4 bytes);
//  - rows past B are not copied; a run's units past H (the last rank's,
//    where H % C != 0) are zero-filled by a short src-size, so no byte past
//    a stream row's H units, or past the stream, is read; c_prev or h_prev
//    outside [0, T) is zero-filled whole (src-size 0, read from the
//    stream's base);
//  - a bf16 word with no cp.async width (H or U odd) has no fill: the plan
//    gives a bf16 instance no such cluster plan (ops/rnn_plan.py `bwd_plan`
//    with ring16) and the launch refuses one, and a stream whose base the
//    shape's width does not divide (rec_ring_check; the wrappers copy such
//    a view first).
// The cells read their words from the ring and widen them at use.  The
// fill's geometry, the words' addresses and the cells themselves are
// rebuilt at every step (rec_opaque) rather than held through the product,
// where the launch bounds leave 128 registers a thread: held, they
// spilled.  Step
// s+1's copies are issued after the __syncthreads that ends step s's
// cells (the ring's last readers), stay in flight during the product, and
// each thread waits for its own (cp.async.wait_group 0) before the
// __syncthreads of rec_bwd_send, which then publishes the whole ring to
// step s+1's cells; no barrier is added.  The GRU's in-place case holds
// as in the per-cell ring: step s+1's copies read time row t -/+ 1, never
// row t, the only row step s's cells write, and every copy has landed
// (each thread waited, then that barrier) before any cell of step s+1
// writes row t -/+ 1.
// Cost of a step, in cycles (ops/rnn_plan.py `bwd_step_cycles`, its
// constants from probes/rec_phases.cu; nw = nkg BT / RB warps, p = KL G +
// RB + KL G RB instructions a unit): the product's issue U p ceil(nw / 4)
// (its weight loads, dS loads and fmaf) plus its shared-memory reads nw U
// (KL G + RB) (the probe finds the two barely overlap), or with few warps
// its latency U (BWD_LATENCY + p); the exchange as the forward's; the
// cells, per cell of a thread, BWD_CELL_CYCLES[G] plus C SUM_RANK_CYCLES
// for the partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>
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

// words of a cell's inputs in the backward's ring: acts or pre (4), tc or
// c, c_prev and dh for the LSTM; gx (3), gh (3), h_prev and dh for the GRU
__host__ __device__ constexpr int rec_bwd_ring(int G)
{
    return G == 4 ? 7 : 8;
}

// bytes of shared memory of one CTA of the backward's cluster instance
// (G gate rows a unit): mbarriers, dS, recv, part, the sW slice and the
// ring (the layout above)
inline size_t rec_bwd_smem(int G, int H, int C, int U, int BT)
{
    return 16 + 16 * (size_t)BT * U + 16 * (size_t)C * U * BT
           + 4 * (size_t)G * H * U + 4 * (size_t)rec_bwd_ring(G) * BT * U;
}

// threads of a backward CTA: a warp per 32 KL output units and row group
inline int rec_bwd_threads(int H, int BT, int RB, int KL)
{
    return 32 * ((H + 32 * KL - 1) / (32 * KL)) * (BT / RB);
}

// output units a lane in the backward's product the kernels are
// instantiated for (ops/rnn_plan.py UNITS_A_LANE)
constexpr int REC_BWD_MAX_KL = 2;

// Checks a backward plan (C ranks, BT rows a tile, RB rows and KL output
// units a lane) for G gate rows of H units: cudaSuccess, or
// cudaErrorInvalidValue for one this instance cannot take.  `smem` must
// be rec_bwd_smem's count.
inline cudaError_t rec_bwd_check(int G, int H, int C, int BT, int RB,
                                 int KL, int smem)
{
    if (G < 3 || G > 4 || C < 1 || C > REC_MAX_CLUSTER || H < 1
            || !rec_rows_a_lane(RB) || BT < RB || BT > REC_MAX_BT
            || BT % RB != 0 || KL < 1 || KL > REC_BWD_MAX_KL)
        return cudaErrorInvalidValue;
    const int U = (H + C - 1) / C;
    const int threads = rec_bwd_threads(H, BT, RB, KL);
    if ((H + U - 1) / U != C || threads > REC_CLUSTER_THREADS
            || U * BT > REC_MAX_CELLS * threads || U * BT % 4 != 0)
        return cudaErrorInvalidValue;
    const size_t need = rec_bwd_smem(G, H, C, U, BT);
    if (need > (size_t)REC_SMEM_LIMIT || need != (size_t)smem)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// The bytes of each cp.async of a word of the bf16 chains' ring (the
// layout above): the widest of 16, 8 and 4 that divides a stream row's H
// units and a run's U units of es bytes and the address `a` (the stream's
// base and the ring's, or 0 for the shape alone); 0 where none does.
// ops/rnn_plan.py `ring_width` restates it.
__host__ __device__ inline int rec_ring_width(int es, int H, int U, size_t a)
{
    const size_t v = (size_t)es * H | (size_t)es * U | a | 16;
    const int w = static_cast<int>(v & (~v + 1));   // its lowest set bit
    return w >= 4 ? w : 0;
}

// A stream of a bf16 chain's ring: its base and bytes a unit.
struct RecRingStream {
    const void* p;
    int es;
};

// Whether a bf16 chain on `instance` takes its streams, checked by the
// entry points before any launch: on the cluster instance, the ring fill
// of H units in runs of U takes each stream by cp.async of its shape's
// width, so cudaErrorInvalidValue where no cp.async takes a shape (H or U
// odd for bf16: a plan the bf16 instance does not run) and
// cudaErrorMisalignedAddress where a base is not aligned to its width
// (the first refusal); the L2 instance reads the streams as they are.
inline cudaError_t rec_ring_check(int instance, int H, int C,
                                  std::initializer_list<RecRingStream> s)
{
    if (instance != INSTANCE_CLUSTER) return cudaSuccess;
    const int U = (H + C - 1) / C;
    for (const RecRingStream& x : s) {
        const int w = rec_ring_width(x.es, H, U, 0);
        if (w == 0) return cudaErrorInvalidValue;
        if (reinterpret_cast<size_t>(x.p) % w)
            return cudaErrorMisalignedAddress;
    }
    return cudaSuccess;
}

// Checks a backward launch plan before any work is queued: the L2
// instance takes C = 1, its tile of l2_bt rows (RB and KL 1) and 8 G H
// l2_bt bytes, for H up to l2_max_h; the cluster one what rec_bwd_check
// takes.
inline cudaError_t rec_bwd_plan_check(int instance, int G, int H, int C,
                                      int BT, int RB, int KL, int smem,
                                      int l2_bt, int l2_max_h)
{
    if (instance == INSTANCE_L2)
        return H <= l2_max_h && C == 1 && BT == l2_bt && RB == 1 && KL == 1
                       && smem == 8 * G * H * l2_bt
                   ? cudaSuccess : cudaErrorInvalidValue;
    if (instance == INSTANCE_CLUSTER)
        return rec_bwd_check(G, H, C, BT, RB, KL, smem);
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

// W-byte asynchronous copy (W 16, 8 or 4; the shared address `dst` and
// `src` aligned to it) of which the first `bytes` come from `src` and the
// rest are zero-filled
__device__ __forceinline__ void cp_async_w(uint32_t dst, const void* src,
                                           int W, int bytes)
{
    if (W == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(dst), "l"(src), "r"(bytes) : "memory");
    else if (W == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                     :: "r"(dst), "l"(src), "r"(bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     :: "r"(dst), "l"(src), "r"(bytes) : "memory");
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

// The input gates of time t of this thread's cells from a bf16 gate
// stream, widened into v [cell][gate] (the bf16 gate reader: what
// rec_prefetch copies, through registers).
template <int G>
__device__ __forceinline__ void rec_load_gates(
    float (&v)[REC_MAX_CELLS][4], const __nv_bfloat16* __restrict__ gx,
    int t, int B, int b0, int nrow, int H, int u0, const RecCells& cl)
{
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
            const __nv_bfloat16* g = gx
                + ((size_t)t * B + b0 + cl.row[j]) * G * H + u0 + cl.u_c[j];
#pragma unroll
            for (int q = 0; q < G; ++q) v[j][q] = __bfloat162float(g[q * H]);
        }
    }
}

// What rec_load_gates loaded into ring slot [BT][U][4].
template <int G>
__device__ __forceinline__ void rec_stash_gates(
    float* slot, const float (&v)[REC_MAX_CELLS][4], int nrow, int H, int U,
    int u0, const RecCells& cl)
{
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
            float* d = slot + ((size_t)cl.row[j] * U + cl.u_c[j]) * 4;
#pragma unroll
            for (int q = 0; q < G; ++q) d[q] = v[j][q];
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

// The start of the kernel: mbarriers, weights, h = 0, step 0's gates
// (of type TX: f32, or bf16 through registers), and the cluster barrier
// after which remote stores may come.
template <int G, typename TX>
__device__ __forceinline__ void rec_prologue(const RecSmem& m,
                                             const TX* __restrict__ gx,
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
    if constexpr (std::is_same<TX, float>::value) {
        rec_prefetch<G>(m.ring, gx, t0, B, b0, nrow, H, U, u0, cl);
    } else {
        float v[REC_MAX_CELLS][4];
        rec_load_gates<G>(v, gx, t0, B, b0, nrow, H, u0, cl);
        rec_stash_gates<G>(m.ring, v, nrow, H, U, u0, cl);
    }
    cp_async_commit();
    cp_async_wait<0>();
    cluster_sync();
}

// The top of step s: thread 0's arrival on the buffer the step fills (the
// other C-1 ranks' blocks to come), and step s+1's gates (time tn): f32
// ones copied into the other ring slot, bf16 ones loaded into v, which
// the kernel stashes there after the product (rec_stash_gates).
template <int G, typename TX>
__device__ __forceinline__ void rec_step_top(const RecSmem& m,
                                             const TX* __restrict__ gx,
                                             float (&v)[REC_MAX_CELLS][4],
                                             int s, int T, int tn, int B,
                                             int b0, int nrow, int H, int C,
                                             int U, int u0, int BT,
                                             const RecCells& cl)
{
    const int nb = (s + 1) & 1;
    if (s + 1 < T) {
        if (threadIdx.x == 0)
            mbar_arrive_expect(m.bar + nb, 4 * (C - 1) * U * BT);
        if constexpr (std::is_same<TX, float>::value)
            rec_prefetch<G>(m.ring + nb * BT * U * 4, gx, tn, B, b0, nrow, H,
                            U, u0, cl);
        else
            rec_load_gates<G>(v, gx, tn, B, b0, nrow, H, u0, cl);
    }
    cp_async_commit();
}

// -- the backward chains' building blocks ------------------------------------

// The shared memory of a backward CTA, cut as the layout above.
struct RecBwdSmem {
    uint64_t* bar;   // [2]
    float* dS;       // [BT][U][4]
    float* recv;     // [2][C][U][BT]
    float* part;     // [2][C U][BT]
    float* wS;       // [U][G][H]
    float* ring;     // [BT][U][R]
};

template <int G>
__device__ __forceinline__ RecBwdSmem rec_bwd_smem_of(float* smem, int H,
                                                      int C, int U, int BT)
{
    RecBwdSmem m;
    m.bar = reinterpret_cast<uint64_t*>(smem);
    m.dS = smem + 4;
    m.recv = m.dS + (size_t)BT * U * 4;
    m.part = m.recv + (size_t)2 * C * U * BT;
    m.wS = m.part + (size_t)2 * C * U * BT;
    m.ring = m.wS + (size_t)G * H * U;
    return m;
}

// The start of a backward kernel: mbarriers, this CTA's gate rows of sW
// [G H, H] into wS[u][g][k] (row g H + u0 + u; zero past H) by cp.async,
// dS zeroed (the rows past B and units past H stay zero, so they add
// nothing to the product).  The caller then copies step 0's inputs,
// waits for all copies and runs the cluster barrier.
template <int G>
__device__ __forceinline__ void rec_bwd_prologue(const RecBwdSmem& m,
                                                 const float* __restrict__ sw,
                                                 int H, int U, int u0, int BT)
{
    if (threadIdx.x == 0) {
        mbar_init(m.bar);
        mbar_init(m.bar + 1);
        mbar_init_fence();
    }
    const int n = U * G * H;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = i % H;
        const int g = (i / H) % G;
        const int u = i / (H * G);
        const bool ok = u0 + u < H;
        cp_async4(m.wS + i,
                  ok ? sw + ((size_t)g * H + u0 + u) * H + k : sw, ok);
    }
    for (int i = threadIdx.x; i < BT * U * 4; i += blockDim.x) m.dS[i] = 0.f;
}

// The sum over the C ranks, in rank order, of the partials of cell (u_c,
// row) that step s-1 produced (b = s & 1): this rank's own block from
// part[b], the others' from recv[b].
__device__ __forceinline__ float rec_bwd_sum(const RecBwdSmem& m, int b,
                                             int C, int q, int U, int BT,
                                             int u_c, int row)
{
    const size_t blk = (size_t)U * BT;
    const float* own = m.part + ((size_t)b * C + q) * blk;
    const float* rv = m.recv + (size_t)b * C * blk;
    const size_t o = (size_t)u_c * BT + row;
    float v = 0.f;
#pragma unroll 4
    for (int r = 0; r < C; ++r) v += (r == q ? own : rv + r * blk)[o];
    return v;
}

// The product of a backward step: out[k][rows] = sum over the own units u
// and gates g of wS[u][g][k] dS[row][u][g], for this thread's KL output
// units k (lane + 32 i, i < KL, of its warp's group of 32 KL) and its RB
// rows, one fmaf chain an output from zero.
template <int G, int RB, int KL>
__device__ __forceinline__ void rec_bwd_partials(const RecBwdSmem& m,
                                                 float* __restrict__ out,
                                                 int H, int U, int BT)
{
    const int nkg = (H + 32 * KL - 1) / (32 * KL);
    const int w = threadIdx.x >> 5;
    const int k0 = w % nkg * 32 * KL + (int)(threadIdx.x & 31);
    const int rg = w / nkg;
    if (k0 >= H) return;
    int kl[KL];   // the lane's units, past H clamped for the loads
#pragma unroll
    for (int i = 0; i < KL; ++i) kl[i] = min(k0 + 32 * i, H - 1);
    float acc[KL][RB];
#pragma unroll
    for (int i = 0; i < KL; ++i)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[i][r] = 0.f;
    const float4* d = reinterpret_cast<const float4*>(m.dS)
                      + (size_t)rg * RB * U;
#pragma unroll 4
    for (int u = 0; u < U; ++u) {
        const float* wu = m.wS + (size_t)u * G * H;
        float wv[KL][G];
#pragma unroll
        for (int i = 0; i < KL; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g) wv[i][g] = wu[g * H + kl[i]];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            const float4 dv = d[(size_t)r * U + u];
#pragma unroll
            for (int i = 0; i < KL; ++i) {
                acc[i][r] = fmaf(wv[i][0], dv.x, acc[i][r]);
                acc[i][r] = fmaf(wv[i][1], dv.y, acc[i][r]);
                acc[i][r] = fmaf(wv[i][2], dv.z, acc[i][r]);
                if constexpr (G == 4)
                    acc[i][r] = fmaf(wv[i][3], dv.w, acc[i][r]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < KL; ++i) {
        if (k0 + 32 * i >= H) break;
        float* o = out + (size_t)(k0 + 32 * i) * BT + rg * RB;
#pragma unroll
        for (int r = 0; r < RB; ++r) o[r] = acc[i][r];
    }
}

// The exchange of a backward step: block p of part[nb] (rank p's units,
// all BT rows) to recv[nb][q] of rank p, by one bulk copy each,
// completing on rank p's bar[nb].
__device__ __forceinline__ void rec_bwd_send(const RecBwdSmem& m, int nb,
                                             int C, int U, int BT)
{
    fence_proxy_async();
    __syncthreads();
    const int p = threadIdx.x;
    const uint32_t q = cluster_rank();
    if (p < C && p != (int)q) {
        const size_t blk = (size_t)U * BT;
        const uint32_t src = smem_addr(m.part + ((size_t)nb * C + p) * blk);
        const uint32_t dst = smem_addr(m.recv + ((size_t)nb * C + q) * blk);
        bulk_copy_cluster(map_rank(dst, p), src, 4 * U * BT,
                          map_rank(smem_addr(m.bar + nb), p));
    }
}

// `v` through an opaque register move: what a loop derives from it is
// recomputed in the loop, not hoisted out of it and held in a register
// across the rest of the body.  The bf16 chains pass their ring's
// geometry through it, which would otherwise stay live through the
// product (one set of chunk widths, counts and region addresses a word
// type) and spill.
__device__ __forceinline__ int rec_opaque(int v)
{
    int r;
    asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
    return r;
}

// The geometry of the bf16 chains' ring fill for words of es bytes a
// unit: W bytes a copy (rec_ring_width of the shape and the ring's
// address; each stream's base is aligned to the shape's width,
// rec_ring_check), `run` = U es bytes of a tile row's word, `per` copies
// a run, n = nrow per of the tile, `have` bytes of a run below H, inv =
// 1 / per.  The fills build one for 2-byte and one for 4-byte words at
// every step (es passes rec_opaque: the compiler would otherwise hold
// both through the product).
struct RecRingGeo {
    int W, run, per, n, have;
    float inv;
};

__device__ __forceinline__ RecRingGeo rec_ring_geo(int es, int H, int U,
                                                   int u0, int nrow,
                                                   const float* ring)
{
    es = rec_opaque(es);
    RecRingGeo g;
    g.W = rec_ring_width(es, H, U, smem_addr(ring));
    g.run = es * U;
    g.per = g.run >> (__ffs(g.W) - 1);
    g.n = nrow * g.per;
    g.have = es * min(U, H - u0);
    // i / per by a reciprocal: (i + 0.5) / per lies at least 0.5 / per
    // (>= 2^-10, per <= 512) from an integer, and its float error is below
    // nrow 2^-23 <= 2^-18
    g.inv = __frcp_rn(static_cast<float>(g.per));
    return g;
}

// This thread's copies of one word of a bf16 chain's step into its ring
// region `dst` ([BT][U] units of es bytes, geometry g): the stream `p`,
// rows of `pitch` units, the word at unit `col` of a row (g H for gate g),
// read at time row t for tile rows b0 .. b0 + nrow - 1 (zero-filled where
// !ok), the rank's units u0 .. u0 + U - 1 (zero-filled past H).  `i` is
// the thread's next index in the step's list of copies, carried from word
// to word (threadIdx.x for the first).  Issues the copies; the caller
// commits and waits.
__device__ __forceinline__ void rec_ring_word(float* dst, const void* p,
                                              const RecRingGeo& g, int es,
                                              int pitch, int col, int t,
                                              bool ok, int B, int b0, int u0,
                                              int& i)
{
    u0 = rec_opaque(u0);
    const char* base = static_cast<const char*>(p);
    const uint32_t d = smem_addr(dst);
    const int have = ok ? g.have : 0;
    const size_t pitchb = (size_t)pitch * es;
    const char* row0 = ok ? base + ((size_t)t * B + b0) * pitchb
                                 + (size_t)(col + u0) * es
                          : base;
    for (; i < g.n; i += blockDim.x) {
        const int r = __float2int_rz((static_cast<float>(i) + 0.5f) * g.inv);
        const int off = (i - r * g.per) * g.W;
        const int bytes = min(max(have - off, 0), g.W);
        cp_async_w(d + r * g.run + off, bytes ? row0 + r * pitchb + off : base,
                   g.W, bytes);
    }
    i -= g.n;
}

// Unit e (row U + u_c) of word w of the bf16 chains' ring, of type T
// (float or __nv_bfloat16), widened.
template <typename T>
__device__ __forceinline__ float rec_ring_at(const float* ring, int w,
                                             int BT, int U, int e)
{
    const float* r = ring + (size_t)w * BT * U;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return __bfloat162float(reinterpret_cast<const T*>(r)[e]);
    else
        return r[e];
}

// The same for a word whose type is a run-time flag (bf16 where bf)
__device__ __forceinline__ float rec_ring_at(const float* ring, int w,
                                             int BT, int U, int e, int bf)
{
    return bf ? rec_ring_at<__nv_bfloat16>(ring, w, BT, U, e)
              : rec_ring_at<float>(ring, w, BT, U, e);
}

// After the loop and its cluster barrier: the d_b sums of this thread's
// cells (db[j][g]) through the ring, now free, into db_part[tile][G H],
// each (unit, gate) summed over the tile's rows in order.
template <int G>
__device__ __forceinline__ void rec_bwd_store_db(
    const RecBwdSmem& m, const RecCells& cl,
    const float (&db)[REC_MAX_CELLS][G], float* __restrict__ db_part,
    int tile, int H, int U, int u0, int nrow)
{
    float* s = m.ring;   // [BT][U][G]
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
#pragma unroll
            for (int g = 0; g < G; ++g)
                s[((size_t)cl.row[j] * U + cl.u_c[j]) * G + g] = db[j][g];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < U * G; i += blockDim.x) {
        const int u_c = i / G, g = i % G;
        if (u0 + u_c >= H) continue;
        float v = 0.f;
        for (int row = 0; row < nrow; ++row)
            v += s[((size_t)row * U + u_c) * G + g];
        db_part[(size_t)tile * G * H + g * H + u0 + u_c] = v;
    }
}

// The phase clock of a step, for probes/rec_phases.cu: RecClock<true>
// sums, on each thread, the clock64 cycles of the step's phases (REC_TOP
// the gate copies, REC_PRODUCT the product and its barrier, REC_CELLS,
// REC_SEND, REC_WAIT the wait for the step's h) over the steps, and thread
// 0 stores them at out[REC_PHASES blockIdx.x ..].  The backward kernels
// time the same phases in their own order (REC_TOP the wait for the
// step's ring copies, then the cells, the product with its barrier and
// the next step's copies, the send and the wait for the partials).
// RecClock<false>, the kernels' own, is empty and compiles to nothing.
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

// `f(rb, kl)` (integral constants) for the runtime RB and KL of a checked
// backward plan.
template <typename F>
int rec_with_rb_kl(int RB, int KL, F&& f)
{
    return rec_with_rb(RB, [&](auto rb) {
        return KL == 2 ? f(rb, std::integral_constant<int, 2>{})
                       : f(rb, std::integral_constant<int, 1>{});
    });
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
