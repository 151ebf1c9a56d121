// GRU layer forward and recomputing backward for Hopper (sm_90a), f32.
//
// The cell (CUDNN gate order r, z, n; no hidden bias):
//     r = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z),
//     n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h,
// with gx = x . iW^T + b and gh = h . sW^T.  `reverse` walks time backwards
// and keeps the outputs in natural time order.  T is taken as it is (no
// time padding, no masked rows).
//
// Forward (tt_gru_fwd) replaces the TPU kernel
// taiyaki_tpu/ops/pallas_rnn.py:995 `gru_fused_fwd` with
// emit_residuals=False: h of the layer, for inference and for the
// recomputing backward.
//
// Backward (tt_gru_bwd) replaces pallas_rnn.py:1311 `gru_bwd_recompute`:
// from dh, h and x (no stored gate streams) it rebuilds gx and gh and
// computes d_x, d_sW, d_iW and d_b, the weight gradients as partial sums
// for the caller to add up.
//
// Kernels:
//
// 1. gate_gemm_kernel (gemm.cuh).  Forward: gx = x . iW^T + b [T, B, 3H],
//    which the TPU kernel computes per time block in its body.  Backward:
//    gx again, gh = h_prev . sW^T for all steps at once (the TPU kernel
//    forms it step by step inside its serial loop, pallas_rnn.py:1264-1268;
//    here h is wholly known before the backward starts, so the product
//    leaves the chain), and after the chain d_x = dgx . iW.  Bound:
//    operations at the f32 rate.  The two [T, B, 3H] operands (1.57 GB
//    each at T=2000, B=256, H=256) make a round trip through device memory
//    that the TPU kernel avoids, ~1 ms at 3.35 TB/s against ~100 ms of
//    chain.
//
// 2. gru_rec_kernel: the forward recurrence, on the LSTM kernel's pattern.
//    One block per tile of BT = 8 batch rows, one thread per hidden unit j
//    owning the gate rows j, H+j and 2H+j for the BT rows (24 accumulators)
//    and its h in registers; h of the tile lives in shared memory,
//    double-buffered so one barrier per step suffices.  sW^T ([H, 3H],
//    768 KB at H = 256) does not fit in one SM's 227 KB of shared memory,
//    so every step reads it again from L2 (coalesced: thread j reads
//    column j of each row).  Bound: the serial chain of T dependent steps,
//    each a BT x H x 3H product on one SM.
//
// 3. gru_bwd_rec_kernel: the backward recurrence, walking opposite to the
//    forward.  It carries only dh: per step thread k reads gx, gh (of the
//    GEMMs above) and h_prev for unit k of its rows and forms
//        dz = dh (h_prev - n),  dn_pre = dh (1 - z)(1 - n^2),
//        dr_pre = dn_pre gh_n r (1 - r),  dz_pre = dz z (1 - z),
//        dgx = [dr_pre, dz_pre, dn_pre],  dgh = [dr_pre, dz_pre, dn_pre r],
//    (pallas_rnn.py:1272-1291), writes dgx over gx and dgh over gh (each
//    thread reads its own three values of a row before it writes them, so
//    the update in place is safe and halves the scratch), sums d_b per
//    batch tile in registers, puts dgh of the tile in shared memory
//    (double-buffered, 48 KB at H = 256) and forms
//        dh_prev[k] = sum_g dgh[g] sW[g, k] + dh z,
//    reading column k of sW (3H values) from L2.  Bound: the serial chain.
//
// 4. atb_gemm_kernel (gemm.cuh): d_iW = dgx^T x and d_sW = dgh^T h_prev as
//    split-K partials over slices of the T*B rows, h_prev read by a -B
//    (forward layer) or +B (reversed layer) row shift.  The TPU kernel
//    accumulates them in VMEM across its sequential time grid; Hopper
//    blocks carry nothing across blocks.
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

// h[t, b, :] for the BT-row batch tile of this block.
// gx [T, B, 3H] (input gates incl. bias), swt [H, 3H] = sW^T, h [T, B, H].
template <int BT>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_rec_kernel(const float* __restrict__ gx, const float* __restrict__ swt,
               float* __restrict__ h_out, int T, int B, int H, int reverse)
{
    extern __shared__ __align__(16) float h_s[];   // [2][H][BT]
    const int j = threadIdx.x;
    const bool active = j < H;
    const int b0 = blockIdx.x * BT;
    const int nrow = min(BT, B - b0);
    const int H3 = 3 * H;

    for (int i = threadIdx.x; i < 2 * H * BT; i += blockDim.x) h_s[i] = 0.f;
    float hr[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) hr[r] = 0.f;
    __syncthreads();

    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        const float* hc = h_s + (s & 1) * H * BT;
        float* hn = h_s + ((s + 1) & 1) * H * BT;
        if (active) {
            float acc[3][BT];
#pragma unroll
            for (int r = 0; r < BT; ++r)
#pragma unroll
                for (int q = 0; q < 3; ++q) acc[q][r] = 0.f;

            const float* w = swt + j;
#pragma unroll 4
            for (int k = 0; k < H; ++k) {
                const float* wk = w + (size_t)k * H3;
                const float w0 = __ldg(wk);
                const float w1 = __ldg(wk + H);
                const float w2 = __ldg(wk + 2 * H);
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
                }
            }

            const size_t row = (size_t)t * B + b0;
            const float* g = gx + row * H3 + j;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float g0 = 0.f, g1 = 0.f, g2 = 0.f;
                if (r < nrow) {
                    const float* gr = g + (size_t)r * H3;
                    g0 = gr[0]; g1 = gr[H]; g2 = gr[2 * H];
                }
                const float rg = sigmoidf_(g0 + acc[0][r]);
                const float zg = sigmoidf_(g1 + acc[1][r]);
                const float ng = tanhf(g2 + rg * acc[2][r]);
                const float h = (1.f - zg) * ng + zg * hr[r];
                hr[r] = h;
                hn[j * BT + r] = h;
                if (r < nrow) h_out[(row + r) * H + j] = h;
            }
        }
        __syncthreads();
    }
}

// Backward recurrence for the BT-row batch tile of this block.  dh [T, B,
// H] (gradient of the layer's output), h [T, B, H]; g_x, g_h [T, B, 3H]
// hold gx and gh on entry and dgx and dgh on return; sw [3H, H] = sW;
// db_part [nbt, 3H] per-tile bias gradients.
template <int BT>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_bwd_rec_kernel(const float* __restrict__ dh_out,
                   const float* __restrict__ h, float* __restrict__ g_x,
                   float* __restrict__ g_h, const float* __restrict__ sw,
                   float* __restrict__ db_part, int T, int B, int H,
                   int reverse)
{
    extern __shared__ __align__(16) float g_s[];   // [2][3H][BT]
    const int k = threadIdx.x;
    const bool active = k < H;
    const int b0 = blockIdx.x * BT;
    const int nrow = min(BT, B - b0);
    const int H3 = 3 * H;

    float dh_c[BT], db[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < BT; ++r) dh_c[r] = 0.f;

    for (int s = 0; s < T; ++s) {
        // the gradient chain walks opposite to the forward direction
        const int t = reverse ? s : T - 1 - s;
        // the step that fed this one: t - 1 forward, t + 1 reversed
        const int tp = reverse ? t + 1 : t - 1;
        float* gcur = g_s + (s & 1) * H3 * BT;
        float dhz[BT];
        if (active) {
            const size_t row = (size_t)t * B + b0;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float p[3] = {0.f, 0.f, 0.f};
                dhz[r] = 0.f;
                if (r < nrow) {
                    const size_t o = (row + r) * H + k;
                    const size_t og = (row + r) * H3 + k;
                    const float hp = (tp >= 0 && tp < T)
                        ? h[((size_t)tp * B + b0 + r) * H + k] : 0.f;
                    const float gxr = g_x[og], gxz = g_x[og + H],
                                gxn = g_x[og + 2 * H];
                    const float ghr = g_h[og], ghz = g_h[og + H],
                                ghn = g_h[og + 2 * H];
                    const float rg = sigmoidf_(gxr + ghr);
                    const float zg = sigmoidf_(gxz + ghz);
                    const float ng = tanhf(gxn + rg * ghn);
                    const float dh = dh_out[o] + dh_c[r];
                    const float dz = dh * (hp - ng);
                    const float dn_pre = dh * (1.f - zg) * (1.f - ng * ng);
                    p[0] = dn_pre * ghn * rg * (1.f - rg);
                    p[1] = dz * zg * (1.f - zg);
                    p[2] = dn_pre;
                    dhz[r] = dh * zg;
                    g_x[og] = p[0];
                    g_x[og + H] = p[1];
                    g_x[og + 2 * H] = p[2];
                    p[2] = dn_pre * rg;
                    g_h[og] = p[0];
                    g_h[og + H] = p[1];
                    g_h[og + 2 * H] = p[2];
                    db[0] += p[0];
                    db[1] += p[1];
                    db[2] += dn_pre;
                }
#pragma unroll
                for (int q = 0; q < 3; ++q) gcur[(q * H + k) * BT + r] = p[q];
            }
        }
        __syncthreads();
        if (active) {
            float acc[BT];
#pragma unroll
            for (int r = 0; r < BT; ++r) acc[r] = dhz[r];
            const float* w = sw + k;
#pragma unroll 4
            for (int g = 0; g < H3; ++g) {
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
        for (int q = 0; q < 3; ++q)
            db_part[(size_t)blockIdx.x * H3 + q * H + k] = db[q];
    }
}

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = GRU over x [T, B, D]; gx is caller-allocated scratch
// [T, B, 3H]; swt = sW^T [H, 3H].  All f32, contiguous, on one device.
// Returns cudaGetLastError() after the first failing launch, else 0.
int tt_gru_fwd(const float* x, const float* iW, const float* b,
               const float* swt, float* gx, float* h, int T, int B, int D,
               int H, int reverse, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch_gate_gemm(x, iW, b, gx, M, 3 * H, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)gru_rec_kernel<REC_BT>, smem))) return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    gru_rec_kernel<REC_BT><<<blocks, threads, smem, st>>>(gx, swt, h, T, B,
                                                          H, reverse);
    return static_cast<int>(cudaGetLastError());
}

// GRU layer backward recomputing both gate streams.  Inputs: dh, h
// [T, B, H], x [T, B, D], iW [3H, D], b [3H], sw = sW [3H, H], iwt = iW^T
// [D, 3H].  Scratch: g_x, g_h [T, B, 3H].  Outputs:
// dx [T, B, D], dsw_part [nsplit, 3H, H], diw_part [nsplit, 3H, D],
// db_part [ceil(B/8), 3H].
int tt_gru_bwd(const float* dh, const float* h, const float* x,
               const float* iW, const float* b, const float* sw,
               const float* iwt, float* g_x, float* g_h,
               float* dx, float* dsw_part, float* diw_part, float* db_part,
               int T, int B, int D, int H, int reverse, int nsplit,
               void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B, H3 = 3 * H;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);

    // gx = x iW^T + b and gh[t] = h_prev[t] sW^T, h_prev[t] = h[t -/+ 1],
    // zero at the boundary step
    cudaError_t err = launch_gate_gemm(x, iW, b, g_x, M, H3, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t step = (size_t)B * H3;
    float* gh_zero = reverse ? g_h + (size_t)(T - 1) * step : g_h;
    if ((err = cudaMemsetAsync(gh_zero, 0, step * sizeof(float), st))
            != cudaSuccess)
        return static_cast<int>(err);
    if (T > 1) {
        const float* hsrc = reverse ? h + (size_t)B * H : h;
        float* gdst = reverse ? g_h : g_h + step;
        err = launch_gate_gemm(hsrc, sw, nullptr, gdst, (T - 1) * B, H3, H,
                               st);
        if (err != cudaSuccess) return static_cast<int>(err);
    }

    const size_t smem = 2 * sizeof(float) * H3 * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)gru_bwd_rec_kernel<REC_BT>, smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    gru_bwd_rec_kernel<REC_BT><<<blocks, threads, smem, st>>>(
        dh, h, g_x, g_h, sw, db_part, T, B, H, reverse);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);

    if ((err = launch_gate_gemm(g_x, iwt, nullptr, dx, M, D, H3, st))
            != cudaSuccess)
        return static_cast<int>(err);
    if ((err = launch_atb_gemm(g_x, x, diw_part, M, H3, D, 0, nsplit, st))
            != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(launch_atb_gemm(g_h, h, dsw_part, M, H3, H,
                                            reverse ? B : -B, nsplit, st));
}

}  // extern "C"
