// LSTM layer forward and backward for Hopper (sm_90a), f32 throughout.
//
// Forward (tt_lstm_fwd) replaces the TPU kernel
// taiyaki_tpu/ops/pallas_rnn.py:880 `lstm_fused_fwd`: h[t] of an LSTM layer
// (gate order i, f, g, o; torch cell equations with no hidden bias), the
// time loop walking backwards when `reverse` is set, outputs in natural
// time order.  With emit=None it writes h only (the basecall path); with
// emit="acts" it also writes the backward's residuals: c, the gates after
// their activations acts = [i|f|g|o] and tc = tanh(c).
//
// Backward (tt_lstm_bwd) replaces pallas_rnn.py:385 `lstm_bwd_acts`: from
// dh, acts, tc, c_prev, h and x it computes d_x, d_sW, d_iW and d_b, the
// weight gradients as partial sums for the caller to add up.
//
// Kernels:
//
// 1. gate_gemm_kernel (gemm.cuh): gx = x . iW^T + b, which the TPU kernel
//    computes in its own body per time block (pallas_rnn.py:805-817);
//    in the backward d_x = dpre . iW.  Its [T, B, 4H] operand makes one
//    round trip through device memory that the TPU kernel avoids; at
//    T=800, B=256, H=256 that is 0.84 GB, ~0.25 ms at 3.35 TB/s, small
//    beside the recurrence.
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
//    BT x H x 4H product on one SM.  The ACTS flag only adds stores of
//    values the step computes anyway.
//
// 3. lstm_bwd_rec_kernel: the backward recurrence, the mirror of 2 in the
//    opposite time direction.  Thread j computes the four gate gradients
//    of unit j for its BT rows from the stored activations (no
//    transcendentals), writes them to dpre [T, B, 4H], keeps dc in
//    registers and sums d_b over its rows and steps (per batch tile
//    partials, as the TPU kernel returns them).  The gate gradients of the
//    tile go to shared memory (double-buffered, 64 KB at H = 256), and
//    thread j forms dh_{next}[j] = sum_g dpre[g] . sW[g, j], reading
//    column j of sW from L2 each step.  Bound: the serial chain, as in 2.
//    The TPU kernel accumulates d_sW and d_iW in VMEM across its
//    sequential time grid (pallas_rnn.py:272-278); Hopper blocks carry
//    nothing across blocks, so those products are left to kernel 4.
//
// 4. atb_gemm_kernel (gemm.cuh): d_iW = dpre^T x and d_sW = dpre^T h_prev
//    as split-K partials over slices of the T*B rows, h_prev read by a
//    -B (forward layer) or +B (reversed layer) row shift.
//
// Rows of the last batch tile past B run on zeros and are never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

__device__ __forceinline__ float sigmoidf_(float x)
{
    return 1.f / (1.f + expf(-x));
}

constexpr int REC_BT = 8;          // batch rows per block
constexpr int REC_MAX_THREADS = 512;

// h[t, b, :] for the BT-row batch tile of this block; with ACTS also
// c, acts = [i|f|g|o] and tc = tanh(c).
// gx [T, B, 4H] (input gates incl. bias), swt [H, 4H] = sW^T, h [T, B, H].
template <int BT, bool ACTS>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_rec_kernel(const float* __restrict__ gx, const float* __restrict__ swt,
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
            const float* g = gx + ((size_t)t * B + b0) * H4 + j;
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
                    if (ACTS) {
                        c_out[o] = c[r];
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
// dh [T, B, H] (gradient of the layer's output), acts [T, B, 4H],
// tc / cprev [T, B, H], sw [4H, H] = sW.
template <int BT>
__global__ void __launch_bounds__(REC_MAX_THREADS)
lstm_bwd_rec_kernel(const float* __restrict__ dh_out,
                    const float* __restrict__ acts,
                    const float* __restrict__ tcs,
                    const float* __restrict__ cprev,
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
        float* gcur = g_s + (s & 1) * H4 * BT;
        if (active) {
            const size_t row = (size_t)t * B + b0;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float p[4] = {0.f, 0.f, 0.f, 0.f};
                if (r < nrow) {
                    const size_t o = (row + r) * H + j;
                    const float* a = acts + (row + r) * H4 + j;
                    const float ig = a[0], fg = a[H], gg = a[2 * H],
                                og = a[3 * H];
                    const float tc = tcs[o];
                    const float dh = dh_out[o] + dh_c[r];
                    const float d_o = dh * tc;
                    const float dc = dh * og * (1.f - tc * tc) + dc_c[r];
                    p[0] = dc * gg * ig * (1.f - ig);
                    p[1] = dc * cprev[o] * fg * (1.f - fg);
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

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = LSTM over x [T, B, D]; gx is caller-allocated scratch
// [T, B, 4H]; swt = sW^T [H, 4H].  With acts non-null (emit="acts") also
// c, tc [T, B, H] and acts [T, B, 4H].  All f32, contiguous, on one
// device.  Returns cudaGetLastError() after the first failing launch,
// else 0.
int tt_lstm_fwd(const float* x, const float* iW, const float* b,
                const float* swt, float* gx, float* h, float* c, float* acts,
                float* tc, int T, int B, int D, int H, int reverse,
                void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B, N = 4 * H;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    dim3 ggrid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    gate_gemm_kernel<<<ggrid, GEMM_THREADS, 0, st>>>(x, iW, b, gx, M, N, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    int rc;
    if (acts != nullptr) {
        if ((rc = set_smem((const void*)lstm_rec_kernel<REC_BT, true>, smem)))
            return rc;
        lstm_rec_kernel<REC_BT, true><<<blocks, threads, smem, st>>>(
            gx, swt, h, c, acts, tc, T, B, H, reverse);
    } else {
        if ((rc = set_smem((const void*)lstm_rec_kernel<REC_BT, false>, smem)))
            return rc;
        lstm_rec_kernel<REC_BT, false><<<blocks, threads, smem, st>>>(
            gx, swt, h, nullptr, nullptr, nullptr, T, B, H, reverse);
    }
    return static_cast<int>(cudaGetLastError());
}

// LSTM layer backward from stored activations.  Inputs: dh, tc, cprev, h
// [T, B, H], acts [T, B, 4H], x [T, B, D], sw = sW [4H, H], iwt = iW^T
// [D, 4H].  Scratch: dpre [T, B, 4H].  Outputs: dx [T, B, D], dsw_part
// [nsplit, 4H, H], diw_part [nsplit, 4H, D], db_part [ceil(B/8), 4H].
int tt_lstm_bwd(const float* dh, const float* acts, const float* tc,
                const float* cprev, const float* h, const float* x,
                const float* sw, const float* iwt, float* dpre, float* dx,
                float* dsw_part, float* diw_part, float* db_part, int T,
                int B, int D, int H, int reverse, int nsplit, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B, H4 = 4 * H;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);

    const size_t smem = 2 * sizeof(float) * H4 * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)lstm_bwd_rec_kernel<REC_BT>, smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    lstm_bwd_rec_kernel<REC_BT><<<blocks, threads, smem, st>>>(
        dh, acts, tc, cprev, sw, dpre, db_part, T, B, H, reverse);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    dim3 xgrid((D + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    gate_gemm_kernel<<<xgrid, GEMM_THREADS, 0, st>>>(dpre, iwt, nullptr, dx,
                                                    M, D, H4);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);

    const int kslice = (M + nsplit - 1) / nsplit;
    dim3 igrid((D + GEMM_BN - 1) / GEMM_BN, (H4 + GEMM_BM - 1) / GEMM_BM,
               nsplit);
    atb_gemm_kernel<<<igrid, GEMM_THREADS, 0, st>>>(dpre, x, diw_part, M, H4,
                                                   D, 0, kslice);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);

    // h_prev[t] = h[t - 1] for a forward layer, h[t + 1] for a reversed one
    dim3 sgrid((H + GEMM_BN - 1) / GEMM_BN, (H4 + GEMM_BM - 1) / GEMM_BM,
               nsplit);
    atb_gemm_kernel<<<sgrid, GEMM_THREADS, 0, st>>>(
        dpre, h, dsw_part, M, H4, H, reverse ? B : -B, kslice);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
