// LSTM layer forward and backwards for Hopper (sm_90a), f32 throughout.
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
// Kernels:
//
// 1. gate_gemm_kernel (gemm.cuh): gx = x . iW^T + b, which the TPU kernel
//    computes in its own body per time block (pallas_rnn.py:805-817);
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
// 2. lstm_rec_kernel: the forward recurrence.  One block per tile of
//    BT = 8 batch rows, one thread per hidden unit j; thread j owns the
//    four gate rows j, H+j, 2H+j, 3H+j for all BT rows (32 accumulators)
//    and the cell state c of its unit in registers; h of the tile lives in
//    shared memory, double-buffered so one barrier per step suffices.  The
//    recurrent weights (sW^T, [H, 4H], 1 MB at H = 256) do not fit in one
//    SM's 227 KB of shared memory, so every step reads them again from L2
//    (coalesced: thread j reads column j of each row of sW^T).  What
//    bounds it is the serial chain of T dependent steps, each a
//    BT x H x 4H product on one SM.  The emit modes only add stores of
//    values the step computes anyway; pre is written over gx (each value
//    after its only read), so it needs no stream of its own.
//
// 3. lstm_bwd_rec_kernel: the backward recurrence, the mirror of 2 in the
//    opposite time direction.  Thread j computes the four gate gradients
//    of unit j for its BT rows, from the stored activations (no
//    transcendentals) or, with FROM_PRE, from pre and c (four sigmoid or
//    tanh and tanh(c) per row and step, as the TPU kernel's
//    _lstm_cell_bwd), writes them to dpre [T, B, 4H], keeps dc in
//    registers and sums d_b over its rows and steps (per batch tile
//    partials, as the TPU kernel returns them).  c_prev is read from a
//    stream at a time offset: c_prev itself (offset 0) or c one step back
//    in the forward's direction (the recomputing backward, which keeps no
//    c_prev).  The gate gradients of the tile go to shared memory
//    (double-buffered, 64 KB at H = 256), and thread j forms
//    dh_{next}[j] = sum_g dpre[g] . sW[g, j], reading column j of sW from
//    L2 each step.  Bound: the serial chain, as in 2.  The TPU kernels
//    accumulate d_sW and d_iW in VMEM across their sequential time grid
//    (pallas_rnn.py:272-278); Hopper blocks carry nothing across blocks,
//    so those products are left to kernel 4.
//
// 4. atb_gemm_kernel (gemm.cuh): d_iW = dpre^T x and d_sW = dpre^T h_prev
//    as split-K partials over slices of the T*B rows, h_prev read by a
//    -B (forward layer) or +B (reversed layer) row shift.
//
// Rows of the last batch tile past B run on zeros and are never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "gemm.cuh"

namespace {

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

// gx is read only, except under EMIT_PRE, which writes pre over it
template <int EMIT>
using gx_ptr = typename std::conditional<EMIT == EMIT_PRE, float*,
                                         const float*>::type;

// h[t, b, :] for the BT-row batch tile of this block, and what EMIT asks.
// gx [T, B, 4H] (input gates incl. bias; pre on return under EMIT_PRE),
// swt [H, 4H] = sW^T, h [T, B, H].
template <int BT, int EMIT>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_rec_kernel(gx_ptr<EMIT> __restrict__ gx, const float* __restrict__ swt,
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ acts_out, float* __restrict__ tc_out,
                int T, int B, int H, int reverse)
{
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
            const gx_ptr<EMIT> g = gx + ((size_t)t * B + b0) * H4 + j;
#pragma unroll
            for (int r = 0; r < BT; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    acc[q][r] = r < nrow ? g[(size_t)r * H4 + q * H] : 0.f;

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
                    h_out[o] = h;
                    if (EMIT != EMIT_H) c_out[o] = c[r];
                    if constexpr (EMIT == EMIT_PRE) {
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            g[(size_t)r * H4 + q * H] = acc[q][r];
                    }
                    if (EMIT == EMIT_ACTS) {
                        tc_out[o] = tc;
                        float* a = acts_out + (row + r) * H4 + j;
                        a[0] = ig; a[H] = fg; a[2 * H] = gg; a[3 * H] = og;
                    }
                }
            }
        }
        __syncthreads();
    }
}

// Backward recurrence for the BT-row batch tile of this block: gate
// gradients dpre [T, B, 4H] and per-tile bias gradients db_part [nbt, 4H].
// dh [T, B, H] (gradient of the layer's output); gates [T, B, 4H] = acts,
// or pre with FROM_PRE; cs [T, B, H] = tanh(c), or c with FROM_PRE;
// c_prev of step t is cprev[t + cshift] (zero outside [0, T));
// sw [4H, H] = sW.
template <int BT, bool FROM_PRE>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_bwd_rec_kernel(const float* __restrict__ dh_out,
                    const float* __restrict__ gates,
                    const float* __restrict__ cs,
                    const float* __restrict__ cprev, int cshift,
                    const float* __restrict__ sw, float* __restrict__ dpre,
                    float* __restrict__ db_part, int T, int B, int H,
                    int reverse)
{
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
                    const float* a = gates + (row + r) * H4 + j;
                    float ig, fg, gg, og, tc;
                    if (FROM_PRE) {
                        ig = sigmoidf_(a[0]);
                        fg = sigmoidf_(a[H]);
                        gg = tanhf(a[2 * H]);
                        og = sigmoidf_(a[3 * H]);
                        tc = tanhf(cs[o]);
                    } else {
                        ig = a[0]; fg = a[H]; gg = a[2 * H]; og = a[3 * H];
                        tc = cs[o];
                    }
                    const float cp = has_prev
                        ? cprev[((size_t)tp * B + b0 + r) * H + j] : 0.f;
                    const float dh = dh_out[o] + dh_c[r];
                    const float d_o = dh * tc;
                    const float dc = dh * og * (1.f - tc * tc) + dc_c[r];
                    p[0] = dc * gg * ig * (1.f - ig);
                    p[1] = dc * cp * fg * (1.f - fg);
                    p[2] = dc * ig * (1.f - gg * gg);
                    p[3] = d_o * og * (1.f - og);
                    dc_c[r] = dc * fg;
                    float* d = dpre + (row + r) * H4 + j;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        d[q * H] = p[q];
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

template <int EMIT>
int launch_lstm_rec(float* gx, const float* swt, float* h, float* c,
                    float* acts, float* tc, int T, int B, int H, int reverse,
                    cudaStream_t st)
{
    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)lstm_rec_kernel<REC_BT, EMIT>, smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    lstm_rec_kernel<REC_BT, EMIT><<<blocks, threads, smem, st>>>(
        gx, swt, h, c, acts, tc, T, B, H, reverse);
    return static_cast<int>(cudaGetLastError());
}

// The chain (kernel 3) and the three products after it (d_x, d_iW, d_sW);
// arguments as tt_lstm_bwd's, c_prev of step t being cprev[t + cshift].
template <bool FROM_PRE>
int lstm_bwd_chain(const float* dh, const float* gates, const float* cs,
                   const float* cprev, int cshift, const float* h,
                   const float* x, const float* sw, const float* iwt,
                   float* dpre, float* dx, float* dsw_part, float* diw_part,
                   float* db_part, int T, int B, int D, int H, int reverse,
                   int nsplit, cudaStream_t st)
{
    const int M = T * B, H4 = 4 * H;
    const size_t smem = 2 * sizeof(float) * H4 * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)lstm_bwd_rec_kernel<REC_BT, FROM_PRE>,
                       smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    lstm_bwd_rec_kernel<REC_BT, FROM_PRE><<<blocks, threads, smem, st>>>(
        dh, gates, cs, cprev, cshift, sw, dpre, db_part, T, B, H, reverse);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((err = launch_gate_gemm(dpre, iwt, nullptr, dx, M, D, H4, st))
            != cudaSuccess)
        return static_cast<int>(err);
    if ((err = launch_atb_gemm(dpre, x, diw_part, M, H4, D, 0, nsplit, st))
            != cudaSuccess)
        return static_cast<int>(err);
    // h_prev[t] = h[t - 1] for a forward layer, h[t + 1] for a reversed one
    return static_cast<int>(launch_atb_gemm(dpre, h, dsw_part, M, H4, H,
                                            reverse ? B : -B, nsplit, st));
}

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = LSTM over x [T, B, D]; gx is caller-allocated scratch
// [T, B, 4H]; swt = sW^T [H, 4H].  `emit` 0: h only; 1: also c [T, B, H];
// 2: also c, and pre [T, B, 4H] written over gx; 3: also c, tc [T, B, H]
// and acts [T, B, 4H].  All f32, contiguous, on one device.  Returns
// cudaGetLastError() after the first failing launch, else 0.
int tt_lstm_fwd(const float* x, const float* iW, const float* b,
                const float* swt, float* gx, float* h, float* c, float* acts,
                float* tc, int T, int B, int D, int H, int reverse, int emit,
                void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS || emit < EMIT_H || emit > EMIT_ACTS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch_gate_gemm(x, iW, b, gx, M, 4 * H, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (emit) {
    case EMIT_H:
        return launch_lstm_rec<EMIT_H>(gx, swt, h, nullptr, nullptr, nullptr,
                                       T, B, H, reverse, st);
    case EMIT_C:
        return launch_lstm_rec<EMIT_C>(gx, swt, h, c, nullptr, nullptr, T, B,
                                       H, reverse, st);
    case EMIT_PRE:
        return launch_lstm_rec<EMIT_PRE>(gx, swt, h, c, nullptr, nullptr, T,
                                         B, H, reverse, st);
    default:
        return launch_lstm_rec<EMIT_ACTS>(gx, swt, h, c, acts, tc, T, B, H,
                                          reverse, st);
    }
}

// LSTM layer backward from stored gates.  Inputs: dh, cprev, h [T, B, H],
// x [T, B, D], sw = sW [4H, H], iwt = iW^T [D, 4H], and acts [T, B, 4H]
// with tc [T, B, H] (from_pre 0) or pre [T, B, 4H] with c [T, B, H]
// (from_pre 1) as gates and cs.  Scratch: dpre [T, B, 4H].  Outputs:
// dx [T, B, D], dsw_part [nsplit, 4H, H], diw_part [nsplit, 4H, D],
// db_part [ceil(B/8), 4H].
int tt_lstm_bwd(const float* dh, const float* gates, const float* cs,
                const float* cprev, const float* h, const float* x,
                const float* sw, const float* iwt, float* dpre, float* dx,
                float* dsw_part, float* diw_part, float* db_part, int T,
                int B, int D, int H, int reverse, int nsplit, int from_pre,
                void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (from_pre)
        return lstm_bwd_chain<true>(dh, gates, cs, cprev, 0, h, x, sw, iwt,
                                    dpre, dx, dsw_part, diw_part, db_part, T,
                                    B, D, H, reverse, nsplit, st);
    return lstm_bwd_chain<false>(dh, gates, cs, cprev, 0, h, x, sw, iwt,
                                 dpre, dx, dsw_part, diw_part, db_part, T, B,
                                 D, H, reverse, nsplit, st);
}

// LSTM layer backward rebuilding pre.  Inputs: dh, c, h [T, B, H], x
// [T, B, D], iW [4H, D], b [4H], sw = sW [4H, H], iwt = iW^T [D, 4H].
// Scratch: pre and dpre [T, B, 4H].  Outputs as tt_lstm_bwd's.
int tt_lstm_bwd_recompute(const float* dh, const float* c, const float* h,
                          const float* x, const float* iW, const float* b,
                          const float* sw, const float* iwt, float* pre,
                          float* dpre, float* dx, float* dsw_part,
                          float* diw_part, float* db_part, int T, int B,
                          int D, int H, int reverse, int nsplit, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int H4 = 4 * H;
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    // pre[t] = x[t] iW^T + b + h_prev[t] sW^T, h_prev[t] = h[t -/+ 1]; the
    // boundary step's h_prev is zero and adds nothing
    cudaError_t err = launch_gate_gemm(x, iW, b, pre, T * B, H4, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (T > 1) {
        const float* hsrc = reverse ? h + (size_t)B * H : h;
        float* pdst = reverse ? pre : pre + (size_t)B * H4;
        err = launch_gate_gemm(hsrc, sw, nullptr, pdst, (T - 1) * B, H4, H,
                               st, true);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    // c_prev[t] = c[t - 1] forward, c[t + 1] reversed
    return lstm_bwd_chain<true>(dh, pre, c, c, reverse ? 1 : -1, h, x, sw,
                                iwt, dpre, dx, dsw_part, diw_part, db_part,
                                T, B, D, H, reverse, nsplit, st);
}

}  // extern "C"
