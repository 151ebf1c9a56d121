// LSTM layer forward and backwards for Hopper (sm_90a), f32 arithmetic,
// f32 or bf16 streams.
//
// Forward (tt_lstm_fwd) replaces the TPU kernel
// taiyaki_tpu/ops/pallas_rnn.py:880 `lstm_fused_fwd`: h[t] of an LSTM layer
// (gate order i, f, g, o; torch cell equations with no hidden bias), the
// time loop walking backwards when `reverse` is set, outputs in natural
// time order.  What it writes beside h is its emit mode: nothing (the
// basecall path), c (for the recomputing backward), c and the
// pre-activations pre (for the backward from stored pre) or c, the gates
// after their activations acts = [i|f|g|o] and tc = tanh(c) (for the
// backward from stored activations, the training default).
//
// Backwards, each from dh to d_x, d_sW, d_iW and d_b, the weight gradients
// as partial sums for the caller to add up:
// - tt_lstm_bwd, from acts, tc and c_prev, replaces pallas_rnn.py:385
//   `lstm_bwd_acts`; with `from_pre`, from pre, c and c_prev, it replaces
//   pallas_rnn.py:456 `lstm_bwd_fusedw`;
// - tt_lstm_bwd_recompute, from c, h and x alone, replaces
//   pallas_rnn.py:625 `lstm_bwd_recompute`: it rebuilds pre, then runs
//   the chain of `from_pre`.
//
// The recurrence on given gates, without the input product (the public
// op `lstm_scan` of ops/rnn.py), runs the same chains:
// - tt_lstm_scan_fwd replaces pallas_rnn.py:141 `lstm_fwd`: h, and for the
//   backward c and pre, from gates_x [T, B, 4H] (kernel 2 under EMIT_H, or
//   EMIT_PRE on a copy of gates_x in the pre output, since EMIT_PRE writes
//   pre over the stream it reads and gates_x belongs to the caller; the
//   bf16 instance writes pre into its own stream and needs no copy);
// - tt_lstm_scan_bwd replaces pallas_rnn.py:726 `lstm_bwd`: dpre [T, B,
//   4H] (= d gates_x) from dh, pre, c and c_prev (kernel 3 with FROM_PRE),
//   and with iW also d_x = dpre . iW by kernel 1 from the stored dpre, the
//   product the TPU kernel forms in its body (`_lstm_bwd_dx_kernel`).
// Bound: the serial chain, as for the layer kernels (at T=800, B=256,
// H=256 the operations bound is 1.6 ms and the bytes bound 0.6-0.7 ms,
// against tens of ms of chain).
//
// Kernels:
//
// 1. The gate GEMM (gemm.cuh), on its plan's instance (ops/gemm.py): the
//    tc kernel (3xTF32 on the tensor cores, TMA-fed, gemm_tc.cuh) or, for
//    ragged widths, gate_gemm_kernel (f32 FMA): gx = x . iW^T + b, which
//    the TPU kernel computes in its own body per time block
//    (pallas_rnn.py:805-817);
//    in the backwards d_x = dpre . iW.  Its [T, B, 4H] operand makes one
//    round trip through device memory that the TPU kernel avoids; at
//    T=800, B=256, H=256 that is 0.84 GB, ~0.25 ms at 3.35 TB/s, small
//    beside the recurrence.  The recomputing backward rebuilds pre =
//    x . iW^T + b + h_prev . sW^T with two of these ahead of the chain,
//    the second accumulating onto the first (h_prev is h one row of
//    steps away: on the card h is wholly known before the backward, so
//    the product the TPU kernel forms step by step inside its serial loop,
//    pallas_rnn.py:587-592, leaves the chain).
//
// 2. The forward recurrence, in two instances that compute the same
//    function (within 1e-5 of each other; the sums over k run in another
//    order); ops/rnn_plan.py `rec_plan` picks one by shape before the
//    launch (tt_lstm_fwd's `instance`, C, BT, RB, KS and smem arguments).
//    Both replace the recurrence of pallas_rnn.py:880 `lstm_fused_fwd`
//    (and, on given gates, of pallas_rnn.py:141 `lstm_fwd`).
//    a. lstm_rec_cluster_kernel<RB, EMIT> (the cluster instance, the plan's
//       choice wherever its shared memory fits: every width the repo's
//       models use, up to H ~ 450).  A cluster of C CTAs walks a tile of
//       BT batch rows; rank q keeps the four gate rows of its H/C units,
//       over all H inputs, in its shared memory for the whole launch (128
//       KB at H = 256, C = 8) and receives the other ranks' blocks of h
//       by bulk copies into its shared memory, one mbarrier wait a step;
//       the product runs in KS slices of k (RB rows a lane, partial sums
//       in shared memory), then each thread applies the cell to at most 4
//       (unit, row) cells, the next step's input gates arriving by
//       cp.async meanwhile (rec_cluster.cuh: layout, protocol, per-step
//       cost model).  The plan fills the card: at B = 128, H = 256, C = 8
//       and BT = 9 give 120 CTAs (15 clusters, as many clusters of 8 as
//       an H100 runs at once); the L2 instance 16 blocks.  Bound: the
//       serial chain, T steps of the product's shared-memory reads (the
//       larger term at every shape the repo uses), the exchange and the
//       cells; the operations bound (2 T B 4H (D + H) at 67 TFLOP/s) is
//       2.0 ms at the basecall shape, the chain about twice that.
//    b. lstm_rec_kernel<BT, EMIT> (the L2 instance, for the widths where
//       the slice does not fit: an LSTM at H = 512 needs 4 MB of sW^T,
//       262 KB a CTA even at C = 16).  One block per tile of BT = 8 batch
//       rows, one thread per hidden unit j; thread j owns the four gate
//       rows j, H+j, 2H+j, 3H+j for all BT rows (32 accumulators) and the
//       cell state c of its unit in registers; h of the tile lives in
//       shared memory, double-buffered so one barrier per step suffices.
//       Every step reads sW^T again from L2 (coalesced: thread j reads
//       column j of each row of sW^T).
//    The emit modes only add stores of values the step computes anyway;
//    pre is written over gx (each value after its only read), so it needs
//    no stream of its own.
//
// 3. The backward recurrence, the mirror of 2 in the opposite time
//    direction, in two instances that compute the same function (within
//    1e-4 relative; the sums over the gates run in another order);
//    ops/rnn_plan.py `bwd_plan` picks one by shape before the launch (the
//    backwards' `instance`, C, BT, RB, KS and smem arguments).  Each cell
//    (unit j, row) gets its four gate gradients from the stored
//    activations (no transcendentals) or, with FROM_PRE, from pre and c
//    (four sigmoid or tanh and tanh(c) per row and step, as the TPU
//    kernel's _lstm_cell_bwd); they go to dpre [T, B, 4H], dc is carried
//    in registers and d_b summed over the tile's rows and steps (per batch
//    tile partials, as the TPU kernel returns them).  c_prev is read from
//    a stream at a time offset: c_prev itself (offset 0) or c one step back
//    in the forward's direction (the recomputing backward, which keeps no
//    c_prev).  Then dh_{next}[j] = sum_g dpre[g] . sW[g, j].
//    a. lstm_bwd_rec_cluster_kernel<RB, FROM_PRE> (the cluster instance,
//       the plan's choice wherever it fits: every width the repo's models
//       use).  The forward's cluster and tiles; rank q keeps the four
//       gate rows of sW of its units over all H columns in shared memory
//       (128 KB at H = 256, C = 8) and forms a partial dh_next over all H
//       units from its own gate gradients; each rank's block of it goes to
//       the unit's owner by a bulk copy, and the owner sums the C partials
//       in rank order in its next step's cells.  The next step's inputs of
//       a thread's cells (7 words) arrive by cp.async during the product
//       (the bf16 instances: the tile's words as runs of U units, copied by
//       all threads; rec_cluster.cuh: layout, protocol, safety, per-step
//       cost).  At
//       B = 256, H = 256: C = 8, BT = 18, 120 CTAs in one wave (the L2
//       instance 32 blocks).  Bound: the serial chain of T steps, each the
//       product's shared-memory reads, the exchange and the cells.
//    b. lstm_bwd_rec_kernel<BT, FROM_PRE> (the L2 instance, where the
//       slice does not fit: H = 512).  One block per tile of BT = 8 rows,
//       thread j the cells of unit j; the gate gradients of the tile go to
//       shared memory (double-buffered, 64 KB at H = 256) and thread j
//       reads column j of sW from L2 each step.
//    The TPU kernels accumulate d_sW and d_iW in VMEM across their
//    sequential time grid (pallas_rnn.py:272-278); Hopper blocks carry
//    nothing across blocks, so those products are left to kernel 4.
//
// 4. The atb GEMM (gemm.cuh; the tc kernel or atb_gemm_kernel, as 1):
//    d_iW = dpre^T x and d_sW = dpre^T h_prev
//    as split-K partials over slices of the T*B rows, h_prev read by a
//    -B (forward layer) or +B (reversed layer) row shift.
//
// Rows of the last batch tile past B run on zeros and are never stored.
//
// Streams (`streams`, STREAM_* below).  The f32 instances read and write
// f32 alone.  The bf16 instances store what the JAX package's TPU kernels
// store under its mixed precision (taiyaki_tpu/ops/rnn.py:29-42, the
// port's TAIYAKI_TPU_BF16_STREAMS=1): the forward's residuals c, pre,
// acts and tc in bf16 (pallas_rnn.py:862-872), h in bf16 or f32 (the act
// stream), while the carry h, c stays f32 in registers and shared memory
// and the gx scratch stays f32 (the TPU kernel's f32 VMEM); the backward
// chains read dh (bf16 or f32), the residuals and c_prev in bf16 and widen
// each value at load (pallas_rnn.py:323-333), the chain and dpre stay f32,
// and d_x is written in x's type.  The GEMMs take x and h in bf16 where
// the layer holds them so (gemm.cuh).  The rebuilt pre of the recomputing
// backward is f32, as in the TPU kernel's VMEM.  Under the bf16 instance
// EMIT_PRE writes pre (bf16) into the acts stream and leaves gx alone.
// The bf16 instances are templates of the same kernels on the residuals'
// type; the act and gradient streams' type is a run-time flag in them
// (uniform across a launch), so that each kernel has two instances, not
// four.  The backward cluster instance's bf16 instances lay their ring
// out word-major, [7][BT][U] in each word's own type, so that a word of a
// tile row is the rank's U units in a row, and fill it by cp.async of 16
// bytes where the shape allows (8 or 4 elsewhere), the CTA's threads
// sharing the copies; the cells widen each word at use (rec_cluster.cuh,
// the bf16 chains' ring).
// The recurrence on given gates under the JAX scans' mixed precision
// (taiyaki_tpu/ops/rnn.py:222-257): the forward's bf16 instance on the
// caller's gate stream in bf16 (GX16: the gates through registers, as the
// backward's inputs, rec_cluster.cuh) or f32, h f32, c and pre bf16; the
// chain's bf16 instance (FROM_PRE on bf16 pre and c) storing dpre in dh's
// type (the run-time flag d_bf16), rounded where it is stored while the
// chain goes on from the f32 value (pallas_rnn.py:708-711), the layers
// passing 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "gemm.cuh"
#include "rec_cluster.cuh"

namespace {

// the entry points' `streams` bits: which tensors are bf16
constexpr int STREAM_X_BF16 = 1;     // the layer input x (and d_x)
constexpr int STREAM_H_BF16 = 2;     // h
constexpr int STREAM_RES_BF16 = 4;   // the residuals: the bf16 instance
constexpr int STREAM_DH_BF16 = 8;    // dh (and dpre, as the scan's chain
                                     // stores it)
constexpr int STREAM_ALL = 15;       // what the layers' entry points take

// the residual streams' type of an instance
template <bool BF16>
using res_t = typename std::conditional<BF16, bf16, float>::type;

// v into a stream of f32, or of bf16 where the bf16 instance's flag `bf`
// says so (h into the act stream, dpre into the gradient stream)
template <bool BF16>
__device__ __forceinline__ void store_f(void* p, size_t o, float v, int bf)
{
    if (BF16 && bf)
        static_cast<bf16*>(p)[o] = __float2bfloat16_rn(v);
    else
        static_cast<float*>(p)[o] = v;
}

// dh of a cell from the gradient stream, as store_h
template <bool BF16>
__device__ __forceinline__ float load_dh(const void* dh, size_t o,
                                         int dh_bf16)
{
    if (BF16 && dh_bf16) return widen(static_cast<const bf16*>(dh)[o]);
    return static_cast<const float*>(dh)[o];
}

// `p` advanced by n elements of f32, or of bf16 with `bf`
__host__ __device__ inline const void* advance(const void* p, size_t n,
                                               bool bf)
{
    return static_cast<const char*>(p) + n * (bf ? 2 : 4);
}

__device__ __forceinline__ float sigmoidf_(float x)
{
    return 1.f / (1.f + expf(-x));
}

constexpr int REC_BT = 8;          // batch rows per block
constexpr int REC_MAX_THREADS = 512;

// what the forward writes beside h (the `emit` argument of tt_lstm_fwd)
constexpr int EMIT_H = 0;          // nothing
constexpr int EMIT_C = 1;          // c
constexpr int EMIT_PRE = 2;        // c, and pre over gx
constexpr int EMIT_ACTS = 3;       // c, acts and tc

// gx is read only, except under EMIT_PRE of the f32 instance, which
// writes pre over it (the bf16 instance writes pre into the acts stream);
// with GX16 (the bf16 instance on a bf16 gate stream, the scans) it is
// bf16
template <int EMIT, bool BF16 = false, bool GX16 = false>
using gx_ptr = typename std::conditional<
    GX16, const bf16*,
    typename std::conditional<EMIT == EMIT_PRE && !BF16, float*,
                              const float*>::type>::type;

// h[t, b, :] for the BT-row batch tile of this block, and what EMIT asks.
// gx [T, B, 4H] (input gates incl. bias; pre on return under EMIT_PRE of
// the f32 instance; bf16 with GX16), swt [H, 4H] = sW^T, h [T, B, H] (bf16
// with h_bf16 in the bf16 instance); the residuals in res_t<BF16>.
template <int BT, int EMIT, bool BF16 = false, bool GX16 = false>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_rec_kernel(gx_ptr<EMIT, BF16, GX16> __restrict__ gx,
                const float* __restrict__ swt, void* __restrict__ h_out,
                res_t<BF16>* __restrict__ c_out,
                res_t<BF16>* __restrict__ acts_out,
                res_t<BF16>* __restrict__ tc_out, int T, int B, int H,
                int reverse, int h_bf16)
{
    static_assert(BF16 || !GX16, "a bf16 gate stream: the bf16 instance");
    using R = res_t<BF16>;
    extern __shared__ __align__(16) float h_s[];   // [2][H][BT]
    const int j = threadIdx.x;
    const bool active = j < H;
    const int b0 = blockIdx.x * BT;
    const int nrow = min(BT, B - b0);
    const int H4 = 4 * H;

    for (int i = threadIdx.x; i < 2 * H * BT; i += blockDim.x) h_s[i] = 0.f;
    float c[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) c[r] = 0.f;
    __syncthreads();

    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        const float* hc = h_s + (s & 1) * H * BT;
        float* hn = h_s + ((s + 1) & 1) * H * BT;
        if (active) {
            float acc[4][BT];
            const gx_ptr<EMIT, BF16, GX16> g =
                gx + ((size_t)t * B + b0) * H4 + j;
#pragma unroll
            for (int r = 0; r < BT; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    acc[q][r] = r < nrow ? widen(g[(size_t)r * H4 + q * H])
                                         : 0.f;

            const float* w = swt + j;
#pragma unroll 4
            for (int k = 0; k < H; ++k) {
                const float* wk = w + (size_t)k * H4;
                const float w0 = __ldg(wk);
                const float w1 = __ldg(wk + H);
                const float w2 = __ldg(wk + 2 * H);
                const float w3 = __ldg(wk + 3 * H);
                float hv[BT];
#pragma unroll
                for (int r = 0; r < BT; r += 4) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(hc + k * BT + r);
                    hv[r] = v.x; hv[r + 1] = v.y;
                    hv[r + 2] = v.z; hv[r + 3] = v.w;
                }
#pragma unroll
                for (int r = 0; r < BT; ++r) {
                    acc[0][r] = fmaf(w0, hv[r], acc[0][r]);
                    acc[1][r] = fmaf(w1, hv[r], acc[1][r]);
                    acc[2][r] = fmaf(w2, hv[r], acc[2][r]);
                    acc[3][r] = fmaf(w3, hv[r], acc[3][r]);
                }
            }

            const size_t row = (size_t)t * B + b0;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                const float ig = sigmoidf_(acc[0][r]);
                const float fg = sigmoidf_(acc[1][r]);
                const float gg = tanhf(acc[2][r]);
                const float og = sigmoidf_(acc[3][r]);
                c[r] = fg * c[r] + ig * gg;
                const float tc = tanhf(c[r]);
                const float h = og * tc;
                hn[j * BT + r] = h;
                if (r < nrow) {
                    const size_t o = (row + r) * H + j;
                    store_f<BF16>(h_out, o, h, h_bf16);
                    if (EMIT != EMIT_H) c_out[o] = narrow<R>(c[r]);
                    if constexpr (EMIT == EMIT_PRE && BF16) {
                        R* p = acts_out + (row + r) * H4 + j;
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            p[q * H] = narrow<R>(acc[q][r]);
                    } else if constexpr (EMIT == EMIT_PRE) {
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            g[(size_t)r * H4 + q * H] = acc[q][r];
                    }
                    if (EMIT == EMIT_ACTS) {
                        tc_out[o] = narrow<R>(tc);
                        R* a = acts_out + (row + r) * H4 + j;
                        a[0] = narrow<R>(ig); a[H] = narrow<R>(fg);
                        a[2 * H] = narrow<R>(gg); a[3 * H] = narrow<R>(og);
                    }
                }
            }
        }
        __syncthreads();
    }
}

// The cluster instance of the forward recurrence: what lstm_rec_kernel
// computes, for the tile of BT rows of this cluster, rank q holding units
// [q U, q U + U); the product in KS k slices of RB rows a lane
// (rec_cluster.cuh).  Arguments as lstm_rec_kernel's; C ranks of U units.
// With CLOCK (probes/rec_phases.cu alone) the step's phases are timed
// into `cycles` [blocks, REC_PHASES]; the layers pass nullptr.  With GX16
// the bf16 gates go through registers (rec_step_top, rec_stash_gates).
template <int RB, int EMIT, bool CLOCK = false, bool BF16 = false,
          bool GX16 = false>
__global__ void __launch_bounds__(REC_CLUSTER_THREADS, 1)
lstm_rec_cluster_kernel(gx_ptr<EMIT, BF16, GX16> __restrict__ gx,
                        const float* __restrict__ swt,
                        void* __restrict__ h_out,
                        res_t<BF16>* __restrict__ c_out,
                        res_t<BF16>* __restrict__ acts_out,
                        res_t<BF16>* __restrict__ tc_out, int T, int B,
                        int H, int reverse, int C, int U, int BT, int KS,
                        long long* __restrict__ cycles, int h_bf16)
{
    static_assert(BF16 || !GX16, "a bf16 gate stream: the bf16 instance");
    using R = res_t<BF16>;
    extern __shared__ __align__(16) float smem[];
    const RecSmem m = rec_smem(smem, H, C, U, BT);
    const int b0 = cluster_id() * BT;
    const int nrow = min(BT, B - b0);
    const int u0 = cluster_rank() * U;
    const RecWork wk = rec_work(H, U, KS);
    const bool works = wk.ul_c < U && u0 + wk.ul_c < H;
    const int H4 = 4 * H;

    const RecCells cl = rec_cells(H, U, BT, u0);
    rec_prologue<4>(m, gx, swt, reverse ? T - 1 : 0, B, b0, nrow, H, C, U,
                    u0, BT, cl);
    float c[REC_MAX_CELLS];
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) c[j] = 0.f;
    RecClock<CLOCK> clk;

    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        const int nb = (s + 1) & 1;
        const bool more = s + 1 < T;
        clk.start();
        float v[REC_MAX_CELLS][4];
        rec_step_top<4>(m, gx, v, s, T, reverse ? t - 1 : t + 1, B, b0, nrow,
                        H, C, U, u0, BT, cl);
        clk.template lap<REC_TOP>();
        if (works)
            rec_partials<4, RB>(m, m.hS + (s & 1) * C * U * BT, wk, U, BT);
        if constexpr (GX16)
            if (more) rec_stash_gates<4>(m.ring + nb * BT * U * 4, v, nrow,
                                         H, U, u0, cl);
        __syncthreads();
        cp_async_wait<1>();
        clk.template lap<REC_PRODUCT>();
        const float4* g4 =
            reinterpret_cast<const float4*>(m.ring + (s & 1) * BT * U * 4);
#pragma unroll
        for (int j = 0; j < REC_MAX_CELLS; ++j) {
            if (j >= cl.n) break;
            const int u_c = cl.u_c[j], row = cl.row[j], u = u0 + u_c;
            if (row >= BT || u >= H) continue;
            const float4 pre = rec_sum(
                m, row < nrow ? g4[row * U + u_c]
                              : make_float4(0.f, 0.f, 0.f, 0.f),
                KS, U, BT, u_c, row);
            const float ig = sigmoidf_(pre.x);
            const float fg = sigmoidf_(pre.y);
            const float gg = tanhf(pre.z);
            const float og = sigmoidf_(pre.w);
            c[j] = fg * c[j] + ig * gg;
            const float tc = tanhf(c[j]);
            const float h = og * tc;
            m.hS[(size_t)(nb * C * U + u) * BT + row] = h;
            if (row < nrow) {
                const size_t r = (size_t)t * B + b0 + row;
                const size_t o = r * H + u;
                store_f<BF16>(h_out, o, h, h_bf16);
                if (EMIT != EMIT_H) c_out[o] = narrow<R>(c[j]);
                if constexpr (EMIT == EMIT_PRE && BF16) {
                    R* g = acts_out + r * H4 + u;
                    g[0] = narrow<R>(pre.x); g[H] = narrow<R>(pre.y);
                    g[2 * H] = narrow<R>(pre.z); g[3 * H] = narrow<R>(pre.w);
                } else if constexpr (EMIT == EMIT_PRE) {
                    float* g = gx + r * H4 + u;
                    g[0] = pre.x; g[H] = pre.y; g[2 * H] = pre.z;
                    g[3 * H] = pre.w;
                }
                if (EMIT == EMIT_ACTS) {
                    tc_out[o] = narrow<R>(tc);
                    R* a = acts_out + r * H4 + u;
                    a[0] = narrow<R>(ig); a[H] = narrow<R>(fg);
                    a[2 * H] = narrow<R>(gg); a[3 * H] = narrow<R>(og);
                }
            }
        }
        clk.template lap<REC_CELLS>();
        if (more) {
            rec_send(m, nb, C, U, BT, u0);
            clk.template lap<REC_SEND>();
            mbar_wait(m.bar + nb, (s >> 1) & 1);
            clk.template lap<REC_WAIT>();
        }
    }
    cluster_sync();
    clk.store(cycles);
}

// Backward recurrence (the L2 instance) for the BT-row batch tile of this
// block: gate gradients dpre [T, B, 4H] and per-tile bias gradients
// db_part [nbt, 4H].
// dh [T, B, H] (gradient of the layer's output); gates [T, B, 4H] = acts,
// or pre with FROM_PRE; cs [T, B, H] = tanh(c), or c with FROM_PRE;
// c_prev of step t is cprev[t + cshift] (zero outside [0, T));
// sw [4H, H] = sW.  The gates of type TG, cs and cprev of type TS (f32
// for the f32 instance; bf16, and the gates bf16 or the recomputing
// backward's f32 pre, for the bf16 ones); dh and dpre bf16 with dh_bf16
// and d_bf16 in the bf16 instances (dpre rounded where it is stored; the
// chain goes on from the f32 value).
template <int BT, bool FROM_PRE, typename TG = float, typename TS = float>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_bwd_rec_kernel(const void* __restrict__ dh_out,
                    const TG* __restrict__ gates,
                    const TS* __restrict__ cs,
                    const TS* __restrict__ cprev, int cshift,
                    const float* __restrict__ sw, void* __restrict__ dpre,
                    float* __restrict__ db_part, int T, int B, int H,
                    int reverse, int dh_bf16, int d_bf16)
{
    constexpr bool BF16 = is_bf16<TS>;
    extern __shared__ __align__(16) float g_s[];   // [2][4H][BT]
    const int j = threadIdx.x;
    const bool active = j < H;
    const int b0 = blockIdx.x * BT;
    const int nrow = min(BT, B - b0);
    const int H4 = 4 * H;

    float dh_c[BT], dc_c[BT], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < BT; ++r) { dh_c[r] = 0.f; dc_c[r] = 0.f; }

    for (int s = 0; s < T; ++s) {
        // the gradient chain walks opposite to the forward direction
        const int t = reverse ? s : T - 1 - s;
        const int tp = t + cshift;
        const bool has_prev = tp >= 0 && tp < T;
        float* gcur = g_s + (s & 1) * H4 * BT;
        if (active) {
            const size_t row = (size_t)t * B + b0;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float p[4] = {0.f, 0.f, 0.f, 0.f};
                if (r < nrow) {
                    const size_t o = (row + r) * H + j;
                    const TG* a = gates + (row + r) * H4 + j;
                    float ig, fg, gg, og, tc;
                    if (FROM_PRE) {
                        ig = sigmoidf_(widen(a[0]));
                        fg = sigmoidf_(widen(a[H]));
                        gg = tanhf(widen(a[2 * H]));
                        og = sigmoidf_(widen(a[3 * H]));
                        tc = tanhf(widen(cs[o]));
                    } else {
                        ig = widen(a[0]); fg = widen(a[H]);
                        gg = widen(a[2 * H]); og = widen(a[3 * H]);
                        tc = widen(cs[o]);
                    }
                    const float cp = has_prev
                        ? widen(cprev[((size_t)tp * B + b0 + r) * H + j])
                        : 0.f;
                    const float dh = load_dh<BF16>(dh_out, o, dh_bf16)
                                     + dh_c[r];
                    const float d_o = dh * tc;
                    const float dc = dh * og * (1.f - tc * tc) + dc_c[r];
                    p[0] = dc * gg * ig * (1.f - ig);
                    p[1] = dc * cp * fg * (1.f - fg);
                    p[2] = dc * ig * (1.f - gg * gg);
                    p[3] = d_o * og * (1.f - og);
                    dc_c[r] = dc * fg;
                    const size_t od = (row + r) * H4 + j;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        store_f<BF16>(dpre, od + q * H, p[q], d_bf16);
                        db[q] += p[q];
                    }
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) gcur[(q * H + j) * BT + r] = p[q];
            }
        }
        __syncthreads();
        if (active) {
            float acc[BT];
#pragma unroll
            for (int r = 0; r < BT; ++r) acc[r] = 0.f;
            const float* w = sw + j;
#pragma unroll 4
            for (int g = 0; g < H4; ++g) {
                const float wg = __ldg(w + (size_t)g * H);
                float gv[BT];
#pragma unroll
                for (int r = 0; r < BT; r += 4) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(gcur + g * BT + r);
                    gv[r] = v.x; gv[r + 1] = v.y;
                    gv[r + 2] = v.z; gv[r + 3] = v.w;
                }
#pragma unroll
                for (int r = 0; r < BT; ++r) acc[r] = fmaf(wg, gv[r], acc[r]);
            }
#pragma unroll
            for (int r = 0; r < BT; ++r) dh_c[r] = acc[r];
        }
        // no second barrier: the next step writes the other buffer
    }
    if (active) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            db_part[(size_t)blockIdx.x * H4 + q * H + j] = db[q];
    }
}

// Step t's inputs of this thread's cells into the ring [BT][U][7]: the
// four gates, tc (or c), c_prev (zero where t + cshift is outside [0, T))
// and dh, by cp.async (the f32 instance).  Rows past B are left alone (no
// cell reads them).
__device__ __forceinline__ void lstm_bwd_prefetch(
    float* ring, const float* __restrict__ dh_out,
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ cprev, int cshift, int t, int T, int B, int b0,
    int nrow, int H, int U, int u0, const RecCells& cl)
{
    const int tp = t + cshift;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
            const int u = u0 + cl.u_c[j];
            const size_t r = (size_t)t * B + b0 + cl.row[j];
            float* d = ring + ((size_t)cl.row[j] * U + cl.u_c[j])
                       * rec_bwd_ring(4);
            const float* g = gates + r * 4 * H + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) cp_async4(d + q, g + q * H, true);
            cp_async4(d + 4, cs + r * H + u, true);
            cp_async4(d + 5, has_prev
                      ? cprev + ((size_t)tp * B + b0 + cl.row[j]) * H + u
                      : cs, has_prev);
            cp_async4(d + 6, dh_out + r * H + u, true);
        }
    }
}

// Step t's inputs of the tile into the bf16 instances' word-major ring
// [7][BT][U] (rec_cluster.cuh, the bf16 chains' ring): the four gates (TG:
// bf16, or the recompute's f32 pre), tc or c and c_prev (TS; zero where
// t + cshift is outside [0, T)) and dh (bf16 or f32 by dh_bf16), this
// thread's share of the CTA's copies.
constexpr int LSTM_BWD_WORDS = 7;

template <typename TG, typename TS>
__device__ __forceinline__ void lstm_bwd_ring_fill(
    float* ring, const void* __restrict__ dh, int dh_bf16,
    const TG* __restrict__ gates, const TS* __restrict__ cs,
    const TS* __restrict__ cprev, int cshift, int t, int T, int B, int b0,
    int nrow, int H, int U, int u0, int BT)
{
    const int tp = t + cshift;
    const size_t wb = rec_opaque(BT * U);   // floats a word's region
    const RecRingGeo g2 = rec_ring_geo(2, H, U, u0, nrow, ring);
    const RecRingGeo g4 = rec_ring_geo(4, H, U, u0, nrow, ring);
    constexpr int ge = sizeof(TG), se = sizeof(TS);
    const int de = dh_bf16 ? 2 : 4;
    int i = threadIdx.x;
#pragma unroll
    for (int g = 0; g < 4; ++g)
        rec_ring_word(ring + g * wb, gates, ge == 2 ? g2 : g4, ge, 4 * H,
                      g * H, t, true, B, b0, u0, i);
    rec_ring_word(ring + 4 * wb, cs, se == 2 ? g2 : g4, se, H, 0, t, true, B,
                  b0, u0, i);
    rec_ring_word(ring + 5 * wb, cprev, se == 2 ? g2 : g4, se, H, 0, tp,
                  tp >= 0 && tp < T, B, b0, u0, i);
    rec_ring_word(ring + 6 * wb, dh, de == 2 ? g2 : g4, de, H, 0, t, true, B,
                  b0, u0, i);
}

// The seven words of cell e (row U + u_c) from that ring, widened: the
// cells' inputs as the f32 instance reads them from its slot.
template <typename TG, typename TS>
__device__ __forceinline__ void lstm_bwd_words(
    float (&v)[LSTM_BWD_WORDS], const float* ring, int BT, int U, int e,
    int dh_bf16)
{
    BT = rec_opaque(BT);   // the words' addresses: recomputed a step
    e = rec_opaque(e);
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = rec_ring_at<TG>(ring, g, BT, U, e);
    v[4] = rec_ring_at<TS>(ring, 4, BT, U, e);
    v[5] = rec_ring_at<TS>(ring, 5, BT, U, e);
    v[6] = rec_ring_at(ring, 6, BT, U, e, dh_bf16);
}

// The cluster instance of the backward recurrence: what lstm_bwd_rec_kernel
// computes, for the tile of BT rows of this cluster, rank q holding the
// four gate rows of sW of units [q U, q U + U) and summing the partials of
// those units (rec_cluster.cuh, the backward).  Arguments as
// lstm_bwd_rec_kernel's; C ranks of U units; db_part [ceil(B / BT), 4H].
// With CLOCK (probes/rec_phases.cu alone) the step's phases are timed
// into `cycles`; the layers pass nullptr.  TG, TS, dh_bf16 and d_bf16 as
// lstm_bwd_rec_kernel's.
template <int RB, int KL, bool FROM_PRE, bool CLOCK = false,
          typename TG = float, typename TS = float>
__global__ void __launch_bounds__(REC_CLUSTER_THREADS, 1)
lstm_bwd_rec_cluster_kernel(const void* __restrict__ dh_out,
                            const TG* __restrict__ gates,
                            const TS* __restrict__ cs,
                            const TS* __restrict__ cprev, int cshift,
                            const float* __restrict__ sw,
                            void* __restrict__ dpre,
                            float* __restrict__ db_part, int T, int B, int H,
                            int reverse, int C, int U, int BT,
                            long long* __restrict__ cycles, int dh_bf16,
                            int d_bf16)
{
    constexpr bool BF16 = is_bf16<TS>;
    extern __shared__ __align__(16) float smem[];
    const RecBwdSmem m = rec_bwd_smem_of<4>(smem, H, C, U, BT);
    const int tile = cluster_id();
    const int b0 = tile * BT;
    const int nrow = min(BT, B - b0);
    const int q = cluster_rank();
    const int u0 = q * U;
    const int H4 = 4 * H;
    const RecCells cl = rec_cells(H, U, BT, u0);

    rec_bwd_prologue<4>(m, sw, H, U, u0, BT);
    if constexpr (BF16)
        lstm_bwd_ring_fill(m.ring, dh_out, dh_bf16, gates, cs, cprev, cshift,
                           reverse ? 0 : T - 1, T, B, b0, nrow, H, U, u0, BT);
    else
        lstm_bwd_prefetch(m.ring, static_cast<const float*>(dh_out), gates,
                          cs, cprev, cshift, reverse ? 0 : T - 1, T, B, b0,
                          nrow, H, U, u0, cl);
    cp_async_commit();
    cp_async_wait<0>();
    cluster_sync();
    float dc_c[REC_MAX_CELLS], db[REC_MAX_CELLS][4];
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        dc_c[j] = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) db[j][g] = 0.f;
    }
    RecClock<CLOCK> clk;

    for (int s = 0; s < T; ++s) {
        // the gradient chain walks opposite to the forward direction
        const int t = reverse ? s : T - 1 - s;
        const int nb = (s + 1) & 1;
        const bool more = s + 1 < T;
        clk.start();
        if (more && threadIdx.x == 0)
            mbar_arrive_expect(m.bar + nb, 4 * (C - 1) * U * BT);
        cp_async_wait<0>();
        clk.template lap<REC_TOP>();
        // the bf16 instances rebuild their cells at each step rather than
        // hold them through the product (its registers)
        const RecCells cells = BF16 ? rec_cells(H, rec_opaque(U), BT, u0)
                                    : cl;
#pragma unroll
        for (int j = 0; j < REC_MAX_CELLS; ++j) {
            if (j >= cells.n) break;
            const int u_c = cells.u_c[j], row = cells.row[j], u = u0 + u_c;
            if (row >= nrow || u >= H) continue;
            // the cell's words: its slot of the f32 ring, or widened from
            // the bf16 instances' word-major ring
            float vb[BF16 ? LSTM_BWD_WORDS : 1];
            if constexpr (BF16)
                lstm_bwd_words<TG, TS>(vb, m.ring, BT, U, row * U + u_c,
                                       dh_bf16);
            const float* v = BF16 ? vb
                                  : m.ring + ((size_t)row * U + u_c)
                                                 * rec_bwd_ring(4);
            float ig, fg, gg, og, tc;
            if (FROM_PRE) {
                ig = sigmoidf_(v[0]);
                fg = sigmoidf_(v[1]);
                gg = tanhf(v[2]);
                og = sigmoidf_(v[3]);
                tc = tanhf(v[4]);
            } else {
                ig = v[0]; fg = v[1]; gg = v[2]; og = v[3]; tc = v[4];
            }
            const float cp = v[5];
            const float dh = v[6] + (s > 0 ? rec_bwd_sum(m, s & 1, C, q, U,
                                                         BT, u_c, row)
                                           : 0.f);
            const float d_o = dh * tc;
            const float dc = dh * og * (1.f - tc * tc) + dc_c[j];
            float4 p;
            p.x = dc * gg * ig * (1.f - ig);
            p.y = dc * cp * fg * (1.f - fg);
            p.z = dc * ig * (1.f - gg * gg);
            p.w = d_o * og * (1.f - og);
            dc_c[j] = dc * fg;
            const size_t od = ((size_t)t * B + b0 + row) * H4 + u;
            store_f<BF16>(dpre, od, p.x, d_bf16);
            store_f<BF16>(dpre, od + H, p.y, d_bf16);
            store_f<BF16>(dpre, od + 2 * H, p.z, d_bf16);
            store_f<BF16>(dpre, od + 3 * H, p.w, d_bf16);
            db[j][0] += p.x; db[j][1] += p.y; db[j][2] += p.z;
            db[j][3] += p.w;
            reinterpret_cast<float4*>(m.dS)[(size_t)row * U + u_c] = p;
        }
        clk.template lap<REC_CELLS>();
        if (more) {
            __syncthreads();
            const int tn = reverse ? t + 1 : t - 1;
            // the copies are in flight during the product
            if constexpr (BF16)
                lstm_bwd_ring_fill(m.ring, dh_out, dh_bf16, gates, cs, cprev,
                                   cshift, tn, T, B, b0, nrow, H, U, u0, BT);
            else
                lstm_bwd_prefetch(m.ring, static_cast<const float*>(dh_out),
                                  gates, cs, cprev, cshift, tn, T, B, b0,
                                  nrow, H, U, u0, cl);
            cp_async_commit();
            rec_bwd_partials<4, RB, KL>(
                m, m.part + (size_t)nb * C * U * BT, H, U, BT);
            // the shared ring: every thread's copies land before the send's
            // barrier publishes it to step s+1's cells
            if constexpr (BF16) cp_async_wait<0>();
            clk.template lap<REC_PRODUCT>();
            rec_bwd_send(m, nb, C, U, BT);
            clk.template lap<REC_SEND>();
            mbar_wait(m.bar + nb, (s >> 1) & 1);
            clk.template lap<REC_WAIT>();
        }
    }
    cluster_sync();
    // the bf16 instances' cells again, not held through the loop
    rec_bwd_store_db<4>(m, BF16 ? rec_cells(H, U, BT, u0) : cl, db, db_part,
                          tile, H, U, u0, nrow);
    clk.store(cycles);
}

template <int EMIT, bool BF16, bool GX16>
int launch_lstm_rec(void* gx, const float* swt, void* h, void* c,
                    void* acts, void* tc, int T, int B, int H, int reverse,
                    int h_bf16, cudaStream_t st)
{
    using R = res_t<BF16>;
    const auto kernel = lstm_rec_kernel<REC_BT, EMIT, BF16, GX16>;
    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)kernel, smem))) return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    kernel<<<blocks, threads, smem, st>>>(
        static_cast<gx_ptr<EMIT, BF16, GX16>>(gx), swt, h,
        static_cast<R*>(c), static_cast<R*>(acts), static_cast<R*>(tc), T,
        B, H, reverse, h_bf16);
    return static_cast<int>(cudaGetLastError());
}

// The cluster instance (kernel 2a) on a plan of C ranks, BT rows a tile,
// RB rows a lane and KS k slices.
template <int RB, int EMIT, bool BF16, bool GX16>
int launch_lstm_rec_cluster(void* gx, const float* swt, void* h, void* c,
                            void* acts, void* tc, int T, int B, int H,
                            int reverse, int h_bf16, int C, int BT, int KS,
                            int smem, cudaStream_t st)
{
    using R = res_t<BF16>;
    const int U = (H + C - 1) / C;
    return rec_cluster_launch(lstm_rec_cluster_kernel<RB, EMIT, false, BF16,
                                                      GX16>,
                              C, (B + BT - 1) / BT,
                              rec_cluster_threads(U, BT, RB, KS), smem, st,
                              static_cast<gx_ptr<EMIT, BF16, GX16>>(gx), swt,
                              h,
                              static_cast<R*>(c), static_cast<R*>(acts),
                              static_cast<R*>(tc), T, B, H, reverse, C, U,
                              BT, KS, static_cast<long long*>(nullptr),
                              h_bf16);
}

// Kernel 2 on a checked plan (rec_plan_check): the L2 or cluster instance.
template <int EMIT, bool BF16 = false, bool GX16 = false>
int launch_lstm_rec_plan(void* gx, const float* swt, void* h, void* c,
                         void* acts, void* tc, int T, int B, int H,
                         int reverse, int h_bf16, int instance, int C, int BT,
                         int RB, int KS, int smem, cudaStream_t st)
{
    if (instance == INSTANCE_L2)
        return launch_lstm_rec<EMIT, BF16, GX16>(gx, swt, h, c, acts, tc, T,
                                                 B, H, reverse, h_bf16, st);
    return rec_with_rb(RB, [&](auto rb) {
        return launch_lstm_rec_cluster<decltype(rb)::value, EMIT, BF16,
                                       GX16>(
            gx, swt, h, c, acts, tc, T, B, H, reverse, h_bf16, C, BT, KS,
            smem, st);
    });
}

// Kernel 2 of the f32 or bf16 instance with the emit mode `emit`.
template <bool BF16>
int launch_lstm_rec_emit(int emit, float* gx, const float* swt, void* h,
                         void* c, void* acts, void* tc, int T, int B, int H,
                         int reverse, int h_bf16, int instance, int C,
                         int BT, int RB, int KS, int smem, cudaStream_t st)
{
    switch (emit) {
    case EMIT_H:
        return launch_lstm_rec_plan<EMIT_H, BF16>(
            gx, swt, h, nullptr, nullptr, nullptr, T, B, H, reverse, h_bf16,
            instance, C, BT, RB, KS, smem, st);
    case EMIT_C:
        return launch_lstm_rec_plan<EMIT_C, BF16>(
            gx, swt, h, c, nullptr, nullptr, T, B, H, reverse, h_bf16,
            instance, C, BT, RB, KS, smem, st);
    case EMIT_PRE:
        return launch_lstm_rec_plan<EMIT_PRE, BF16>(
            gx, swt, h, c, acts, nullptr, T, B, H, reverse, h_bf16, instance,
            C, BT, RB, KS, smem, st);
    default:
        return launch_lstm_rec_plan<EMIT_ACTS, BF16>(
            gx, swt, h, c, acts, tc, T, B, H, reverse, h_bf16, instance, C,
            BT, RB, KS, smem, st);
    }
}

// The backward chain (kernel 3) alone: dpre and the per-tile d_b.
template <bool FROM_PRE, typename TG, typename TS>
int launch_lstm_bwd_rec(const void* dh, const TG* gates, const TS* cs,
                        const TS* cprev, int cshift, const float* sw,
                        void* dpre, float* db_part, int T, int B, int H,
                        int reverse, int dh_bf16, int d_bf16,
                        cudaStream_t st)
{
    const auto kernel = lstm_bwd_rec_kernel<REC_BT, FROM_PRE, TG, TS>;
    const size_t smem = 2 * sizeof(float) * 4 * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)kernel, smem))) return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    kernel<<<blocks, threads, smem, st>>>(dh, gates, cs, cprev, cshift, sw,
                                          dpre, db_part, T, B, H, reverse,
                                          dh_bf16, d_bf16);
    return static_cast<int>(cudaGetLastError());
}

// The cluster instance of the chain (kernel 3a) on a plan of C ranks, BT
// rows a tile, RB rows and KL output units a lane.
template <int RB, int KL, bool FROM_PRE, typename TG, typename TS>
int launch_lstm_bwd_rec_cluster(const void* dh, const TG* gates,
                                const TS* cs, const TS* cprev, int cshift,
                                const float* sw, void* dpre, float* db_part,
                                int T, int B, int H, int reverse, int dh_bf16,
                                int d_bf16, int C, int BT, int smem,
                                cudaStream_t st)
{
    const int U = (H + C - 1) / C;
    return rec_cluster_launch(
        lstm_bwd_rec_cluster_kernel<RB, KL, FROM_PRE, false, TG, TS>, C,
        (B + BT - 1) / BT, rec_bwd_threads(H, BT, RB, KL), smem, st, dh,
        gates, cs, cprev, cshift, sw, dpre, db_part, T, B, H, reverse, C, U,
        BT, static_cast<long long*>(nullptr), dh_bf16, d_bf16);
}

// Kernel 3 on a checked plan (rec_bwd_plan_check): the L2 or cluster
// instance; dpre f32, or bf16 with d_bf16 (the bf16 instance).
template <bool FROM_PRE, typename TG, typename TS>
int launch_lstm_bwd_rec_plan(const void* dh, const TG* gates, const TS* cs,
                             const TS* cprev, int cshift, const float* sw,
                             void* dpre, float* db_part, int T, int B,
                             int H, int reverse, int dh_bf16, int d_bf16,
                             int instance, int C, int BT, int RB, int KL,
                             int smem, cudaStream_t st)
{
    if (instance == INSTANCE_L2)
        return launch_lstm_bwd_rec<FROM_PRE>(dh, gates, cs, cprev, cshift,
                                             sw, dpre, db_part, T, B, H,
                                             reverse, dh_bf16, d_bf16, st);
    return rec_with_rb_kl(RB, KL, [&](auto rb, auto kl) {
        return launch_lstm_bwd_rec_cluster<decltype(rb)::value,
                                           decltype(kl)::value, FROM_PRE>(
            dh, gates, cs, cprev, cshift, sw, dpre, db_part, T, B, H,
            reverse, dh_bf16, d_bf16, C, BT, smem, st);
    });
}

// The chain (kernel 3, on the plan's instance) and the three products
// after it (d_x, d_iW, d_sW, on the GEMM plans gemm[0..2], checked by
// chain_plans_check); arguments as tt_lstm_bwd's, c_prev of step t being
// cprev[t + cshift]; h, x and dx of the types `streams` gives.
template <bool FROM_PRE, typename TG, typename TS>
int lstm_bwd_chain(const void* dh, const TG* gates, const TS* cs,
                   const TS* cprev, int cshift, const void* h, const void* x,
                   const float* sw, const float* iwt, float* dpre, void* dx,
                   float* dsw_part, float* diw_part, float* db_part, int T,
                   int B, int D, int H, int reverse, int streams,
                   const int* gemm, int instance, int C, int BT, int RB,
                   int KL, int smem, cudaStream_t st)
{
    const int M = T * B, H4 = 4 * H;
    const bool xb = streams & STREAM_X_BF16;
    int rc = launch_lstm_bwd_rec_plan<FROM_PRE>(
        dh, gates, cs, cprev, cshift, sw, dpre, db_part, T, B, H, reverse,
        (streams & STREAM_DH_BF16) != 0, 0, instance, C, BT, RB, KL, smem,
        st);
    if (rc) return rc;
    cudaError_t err;
    if ((err = gemm_gate(gemm_plan_at(gemm, 0), GemmIn{dpre, false}, iwt,
                         nullptr, GemmOut{dx, xb}, M, D, H4, st))
            != cudaSuccess)
        return static_cast<int>(err);
    if ((err = gemm_atb(gemm_plan_at(gemm, 1), dpre, GemmIn{x, xb}, diw_part,
                        M, H4, D, 0, st)) != cudaSuccess)
        return static_cast<int>(err);
    // h_prev[t] = h[t - 1] for a forward layer, h[t + 1] for a reversed one
    return static_cast<int>(gemm_atb(
        gemm_plan_at(gemm, 2), dpre,
        GemmIn{h, (streams & STREAM_H_BF16) != 0}, dsw_part, M, H4, H,
        reverse ? B : -B, st));
}

// The streams a launch may take: all f32 (0), or the bf16 instance
// (STREAM_RES_BF16) with any of x, h and dh in bf16.
inline bool streams_ok(int streams)
{
    return streams == 0
        || ((streams & STREAM_RES_BF16) && (streams & ~STREAM_ALL) == 0);
}

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = LSTM over x [T, B, D]; gx is caller-allocated f32 scratch
// [T, B, 4H]; swt = sW^T [H, 4H].  `emit` 0: h only; 1: also c [T, B, H];
// 2: also c, and pre [T, B, 4H], written over gx by the f32 instance and
// into `acts` by the bf16 one; 3: also c, tc [T, B, H] and acts
// [T, B, 4H].  `streams` (STREAM_* bits): 0 for all f32, else the bf16
// instance (STREAM_RES_BF16: c, pre, acts and tc in bf16), with x and h
// in bf16 where their bits say.  The recurrence runs on the plan
// (instance, C, BT, RB, KS, smem) of ops/rnn_plan.py `rec_plan`: instance 0
// the L2 kernel (C 1, BT 8, RB 1, KS 1), 1 the cluster kernel; the input
// product on the GEMM plan gemm[0] of ops/gemm.py `gemm_plan`; a plan it
// cannot take returns cudaErrorInvalidValue before any launch.
// Contiguous, on one device.  Returns cudaGetLastError() after the first
// failing launch (or the cluster launch's own error), else 0.
int tt_lstm_fwd(const void* x, const float* iW, const float* b,
                const float* swt, float* gx, void* h, void* c, void* acts,
                void* tc, int T, int B, int D, int H, int reverse, int emit,
                int streams, int instance, int C, int BT, int RB, int KS,
                int smem, const int* gemm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS || emit < EMIT_H || emit > EMIT_ACTS
            || !streams_ok(streams) || (streams & STREAM_DH_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const GemmIn xin{x, (streams & STREAM_X_BF16) != 0};
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 0), xin, iW, D);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gemm_gate(gemm_plan_at(gemm, 0), xin, iW, b, GemmOut{gx, false}, M,
                    4 * H, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int hb = (streams & STREAM_H_BF16) != 0;
    if (streams & STREAM_RES_BF16)
        return launch_lstm_rec_emit<true>(emit, gx, swt, h, c, acts, tc, T,
                                          B, H, reverse, hb, instance, C, BT,
                                          RB, KS, smem, st);
    return launch_lstm_rec_emit<false>(emit, gx, swt, h, c, acts, tc, T, B,
                                       H, reverse, 0, instance, C, BT, RB,
                                       KS, smem, st);
}

// How many clusters of the cluster instance's plan (C ranks, BT rows a
// tile, RB a lane, KS k slices, smem bytes) for H units the card runs at
// once (cudaOccupancyMaxActiveClusters; 0 if none fits), or minus the
// CUDA error.
int tt_lstm_cluster_occupancy(int H, int C, int BT, int RB, int KS,
                              int smem)
{
    if (rec_cluster_check(H, C, BT, RB, KS, smem) != cudaSuccess)
        return -static_cast<int>(cudaErrorInvalidValue);
    const int threads = rec_cluster_threads((H + C - 1) / C, BT, RB, KS);
    return rec_with_rb(RB, [&](auto rb) {
        return rec_cluster_occupancy(
            lstm_rec_cluster_kernel<decltype(rb)::value, EMIT_H>, C, threads,
            smem);
    });
}

// LSTM layer backward from stored gates.  Inputs: dh, cprev, h [T, B, H],
// x [T, B, D], sw = sW [4H, H], iwt = iW^T [D, 4H], and acts [T, B, 4H]
// with tc [T, B, H] (from_pre 0) or pre [T, B, 4H] with c [T, B, H]
// (from_pre 1) as gates and cs.  Scratch: dpre [T, B, 4H] f32.  Outputs:
// dx [T, B, D] (x's type), dsw_part [nsplit, 4H, H], diw_part [nsplit,
// 4H, D], db_part [ceil(B/BT), 4H], the partials' counts those of their
// GEMM plans.  `streams` as tt_lstm_fwd's, with dh's bit: the bf16
// instance reads gates, cs and cprev in bf16.  The chain runs on the plan
// (instance, C, BT, RB, KL, smem) of ops/rnn_plan.py `bwd_plan`: instance
// 0 the L2 kernel (C 1, BT 8, RB 1, KL 1, 32 H BT bytes), 1 the cluster
// kernel; d_x, d_iW and d_sW on the GEMM plans gemm[0..2] (ops/gemm.py
// `chain_plans`); a plan it cannot take returns cudaErrorInvalidValue
// before any launch, and so does the bf16 instance on the cluster
// instance where its ring's fill takes no cp.async (H or U odd), or
// cudaErrorMisalignedAddress where a stream's base is not aligned to its
// copies (rec_ring_check; the wrappers copy such a view first).
int tt_lstm_bwd(const void* dh, const void* gates, const void* cs,
                const void* cprev, const void* h, const void* x,
                const float* sw, const float* iwt, float* dpre, void* dx,
                float* dsw_part, float* diw_part, float* db_part, int T,
                int B, int D, int H, int reverse, int streams,
                const int* gemm, int from_pre, int instance, int C, int BT,
                int RB, int KL, int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || !streams_ok(streams))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_bwd_plan_check(instance, 4, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && (streams & STREAM_RES_BF16))
        err = rec_ring_check(instance, H, C,
                             {{dh, streams & STREAM_DH_BF16 ? 2 : 4},
                              {gates, 2}, {cs, 2}, {cprev, 2}});
    if (err == cudaSuccess)
        err = chain_plans_check(
            gemm, dpre, dpre, iwt, GemmIn{x, (streams & STREAM_X_BF16) != 0},
            GemmIn{h, (streams & STREAM_H_BF16) != 0}, T * B, 4 * H, D, H);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto run = [&](auto g, auto s, auto from) {
        using TG = typename std::remove_pointer<decltype(g)>::type;
        using TS = typename std::remove_pointer<decltype(s)>::type;
        return lstm_bwd_chain<decltype(from)::value>(
            dh, static_cast<const TG*>(gates), static_cast<const TS*>(cs),
            static_cast<const TS*>(cprev), 0, h, x, sw, iwt, dpre, dx,
            dsw_part, diw_part, db_part, T, B, D, H, reverse, streams, gemm,
            instance, C, BT, RB, KL, smem, st);
    };
    using Pre = std::integral_constant<bool, true>;
    using Acts = std::integral_constant<bool, false>;
    const bf16* b = nullptr;
    const float* f = nullptr;
    if (streams & STREAM_RES_BF16)
        return from_pre ? run(b, b, Pre{}) : run(b, b, Acts{});
    return from_pre ? run(f, f, Pre{}) : run(f, f, Acts{});
}

// LSTM layer backward rebuilding pre.  Inputs: dh, c, h [T, B, H], x
// [T, B, D], iW [4H, D], b [4H], sw = sW [4H, H], iwt = iW^T [D, 4H].
// Scratch: pre and dpre [T, B, 4H], f32.  Outputs, plan and `streams` as
// tt_lstm_bwd's (the bf16 instance reads c in bf16; pre is f32); five
// GEMM plans: gemm[0] x iW^T, gemm[1] h_prev sW^T (for T > 1, on (T - 1) B
// rows), then the chain's three.
int tt_lstm_bwd_recompute(const void* dh, const void* c, const void* h,
                          const void* x, const float* iW, const float* b,
                          const float* sw, const float* iwt, float* pre,
                          float* dpre, void* dx, float* dsw_part,
                          float* diw_part, float* db_part, int T, int B,
                          int D, int H, int reverse, int streams,
                          const int* gemm, int instance, int C, int BT,
                          int RB, int KL, int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int H4 = 4 * H;
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || !streams_ok(streams))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool hb = streams & STREAM_H_BF16;
    const GemmIn xin{x, (streams & STREAM_X_BF16) != 0};
    const GemmIn hsrc{reverse ? advance(h, (size_t)B * H, hb) : h, hb};
    float* pdst = reverse ? pre : pre + (size_t)B * H4;
    cudaError_t err = rec_bwd_plan_check(instance, 4, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && (streams & STREAM_RES_BF16))
        err = rec_ring_check(instance, H, C,
                             {{dh, streams & STREAM_DH_BF16 ? 2 : 4},
                              {pre, 4}, {c, 2}});
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 0), xin, iW, D);
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 1), hsrc, sw, H);
    if (err == cudaSuccess)
        err = chain_plans_check(gemm + 2 * GEMM_PLAN_INTS, dpre, dpre, iwt,
                                xin, GemmIn{h, hb}, T * B, H4, D, H);
    if (err != cudaSuccess) return static_cast<int>(err);
    // pre[t] = x[t] iW^T + b + h_prev[t] sW^T, h_prev[t] = h[t -/+ 1]; the
    // boundary step's h_prev is zero and adds nothing
    err = gemm_gate(gemm_plan_at(gemm, 0), xin, iW, b, GemmOut{pre, false},
                    T * B, H4, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (T > 1) {
        err = gemm_gate(gemm_plan_at(gemm, 1), hsrc, sw, nullptr,
                        GemmOut{pdst, false}, (T - 1) * B, H4, H, st, true);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    // c_prev[t] = c[t - 1] forward, c[t + 1] reversed
    const int cshift = reverse ? 1 : -1;
    const int* g = gemm + 2 * GEMM_PLAN_INTS;
    if (streams & STREAM_RES_BF16) {
        const bf16* cb = static_cast<const bf16*>(c);
        return lstm_bwd_chain<true>(dh, static_cast<const float*>(pre), cb,
                                    cb, cshift, h, x, sw, iwt, dpre, dx,
                                    dsw_part, diw_part, db_part, T, B, D, H,
                                    reverse, streams, g, instance, C, BT, RB,
                                    KL, smem, st);
    }
    const float* cf = static_cast<const float*>(c);
    return lstm_bwd_chain<true>(dh, static_cast<const float*>(pre), cf, cf,
                                cshift, h, x, sw, iwt, dpre, dx, dsw_part,
                                diw_part, db_part, T, B, D, H, reverse,
                                streams, g, instance, C, BT, RB, KL, smem,
                                st);
}

// Kernel 14: the LSTM recurrence on given gates.  gx [T, B, 4H] (read
// only), swt = sW^T [H, 4H] -> h [T, B, H] (f32); with pre non-null also
// c [T, B, H] and pre [T, B, 4H].  `streams` (STREAM_* bits): 0 for all
// f32 (gx copied into pre, then overwritten in place by the chain), or
// the bf16 instance (STREAM_RES_BF16: c and pre stored in bf16, pre
// written into its own stream), whose gx is bf16 where STREAM_X_BF16 says
// (read through registers, rec_cluster.cuh); h stays f32 in both, as the
// JAX scans keep it.  The plan as tt_lstm_fwd's.  Returns
// cudaGetLastError() after the first failing launch or copy, else 0.
int tt_lstm_scan_fwd(const void* gx, const float* swt, void* pre, float* h,
                     void* c, int T, int B, int H, int reverse, int streams,
                     int instance, int C, int BT, int RB, int KS, int smem,
                     void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    const bool res16 = streams & STREAM_RES_BF16;
    const bool gx16 = streams & STREAM_X_BF16;
    if (H > REC_MAX_THREADS
            || (streams & ~(STREAM_X_BF16 | STREAM_RES_BF16))
            || (gx16 && !res16) || ((pre == nullptr) != (c == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* g = const_cast<void*>(gx);
    if (res16 && pre == nullptr)
        return gx16 ? launch_lstm_rec_plan<EMIT_H, true, true>(
                          g, swt, h, nullptr, nullptr, nullptr, T, B, H,
                          reverse, 0, instance, C, BT, RB, KS, smem, st)
                    : launch_lstm_rec_plan<EMIT_H, true>(
                          g, swt, h, nullptr, nullptr, nullptr, T, B, H,
                          reverse, 0, instance, C, BT, RB, KS, smem, st);
    if (res16)
        return gx16 ? launch_lstm_rec_plan<EMIT_PRE, true, true>(
                          g, swt, h, c, pre, nullptr, T, B, H, reverse, 0,
                          instance, C, BT, RB, KS, smem, st)
                    : launch_lstm_rec_plan<EMIT_PRE, true>(
                          g, swt, h, c, pre, nullptr, T, B, H, reverse, 0,
                          instance, C, BT, RB, KS, smem, st);
    if (pre == nullptr)
        return launch_lstm_rec_plan<EMIT_H>(g, swt, h, nullptr, nullptr,
                                            nullptr, T, B, H, reverse, 0,
                                            instance, C, BT, RB, KS, smem,
                                            st);
    err = cudaMemcpyAsync(pre, gx, sizeof(float) * T * B * 4 * H,
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_lstm_rec_plan<EMIT_PRE>(pre, swt, h, c, nullptr, nullptr,
                                          T, B, H, reverse, 0, instance, C,
                                          BT, RB, KS, smem, st);
}

// Kernel 15: the LSTM gradient chain on the forward's residuals.  dh, c,
// cprev [T, B, H], pre [T, B, 4H], sw = sW [4H, H] -> dpre [T, B, 4H];
// db_part [ceil(B/BT), 4H] is scratch (the chain sums d_b, which the
// recurrence on given gates has no use for).  With iwt = iW^T [D, 4H]
// non-null also dx [T, B, D] (f32) = dpre . iW from the stored dpre, on
// the GEMM plan gemm[0].  `streams`: 0 for all f32, or the bf16 instance
// (STREAM_RES_BF16: pre, c and cprev bf16), with dh bf16 where
// STREAM_DH_BF16 says and dpre stored in dh's type (rounded where it is
// stored; the chain goes on from the f32 value).
// The plan as tt_lstm_bwd's.
int tt_lstm_scan_bwd(const void* dh, const void* pre, const void* c,
                     const void* cprev, const float* sw, const float* iwt,
                     void* dpre, float* dx, float* db_part, int T, int B,
                     int D, int H, int reverse, int streams, int instance,
                     int C, int BT, int RB, int KL, int smem,
                     const int* gemm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    const bool res16 = streams & STREAM_RES_BF16;
    const int dh16 = (streams & STREAM_DH_BF16) != 0;
    if (H > REC_MAX_THREADS
            || (streams & ~(STREAM_RES_BF16 | STREAM_DH_BF16))
            || (streams && !res16))
        return static_cast<int>(cudaErrorInvalidValue);
    const GemmIn dsrc{dpre, dh16 != 0};
    cudaError_t err = rec_bwd_plan_check(instance, 4, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && res16)
        err = rec_ring_check(instance, H, C,
                             {{dh, dh16 ? 2 : 4}, {pre, 2}, {c, 2},
                              {cprev, 2}});
    if (err == cudaSuccess && iwt != nullptr)
        err = gate_plan_check(gemm_plan_at(gemm, 0), dsrc, iwt, 4 * H);
    if (err != cudaSuccess) return static_cast<int>(err);
    int rc;
    if (res16)
        rc = launch_lstm_bwd_rec_plan<true>(
            dh, static_cast<const bf16*>(pre), static_cast<const bf16*>(c),
            static_cast<const bf16*>(cprev), 0, sw, dpre, db_part, T, B, H,
            reverse, dh16, dh16, instance, C, BT, RB, KL, smem, st);
    else
        rc = launch_lstm_bwd_rec_plan<true>(
            dh, static_cast<const float*>(pre), static_cast<const float*>(c),
            static_cast<const float*>(cprev), 0, sw, dpre, db_part, T, B, H,
            reverse, 0, 0, instance, C, BT, RB, KL, smem, st);
    if (rc || iwt == nullptr) return rc;
    return static_cast<int>(gemm_gate(gemm_plan_at(gemm, 0), dsrc, iwt,
                                      nullptr, GemmOut{dx, false}, T * B, D,
                                      4 * H, st));
}

}  // extern "C"
