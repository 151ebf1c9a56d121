// Tiled f32 GEMMs shared by the recurrent layers (lstm.cu, gru.cu) and
// the standalone entry points (gemm.cu), in two instances that compute the
// same functions: "tc", 3xTF32 on Hopper's tensor cores fed by TMA
// (gemm_tc.cuh), wherever TMA can take the operands (rows a multiple of 4
// floats, 16-byte aligned); "simt", the two f32 FMA kernels below, for the
// rest (ragged widths).  ops/gemm.py `gemm_plan` picks the instance by
// shape and gives its fields (GemmPlan); the entry points check every plan
// before any launch (gate_plan_check, atb_plan_check) and run it
// (gemm_gate, gemm_atb), with no fallback from one instance to the other.
//
// 1. gate_gemm_kernel: C[M, N] = A[M, K] . W[N, K]^T (+ bias) (+ C, with
//    ACCUMULATE).  The input products of the layer forwards (gx = x .
//    W^T + b), which the TPU kernels compute in their own bodies per time
//    block, the backward d_x = dgates . W (W passed transposed), and the
//    gate streams the recomputing backwards rebuild (gh = h_prev . sW^T;
//    the LSTM's pre = gx + h_prev . sW^T, its second product accumulated
//    onto the first).  128x128 output tiles, 8x8 per
//    thread, k-major shared tiles, SIMT FMA.  Bound: operations, 2*M*N*K
//    FLOP against the 67 TFLOP/s f32 rate.
//
// 2. atb_gemm_kernel: C_z[N1, N2] = sum over rows k of slice z of
//    A[k, :]^T B[k + shift, :], with rows of B outside [0, K) read as zero.
//    The weight gradients d_iW = dgates^T x (shift 0) and d_sW =
//    dgates^T h_prev, where h_prev is h one step earlier in the
//    recurrence's direction: shift -B for a forward layer, +B for a
//    reversed one.  The reduction dimension K = T*B is long and the output
//    small, so the grid splits K into slices (grid.z) that each write a
//    partial; the caller sums them, as it sums the TPU kernels' per-tile
//    partials.  Bound: operations, 2*K*N1*N2 FLOP at the f32 rate.
//
// bf16 operands (the LSTM layers' bf16 streams, ops/rnn.py): the gate
// product's A and the atb product's B may be bf16, and the gate product's
// output (d_x).  Both instances widen a bf16 value exactly and sum in f32;
// a bf16 output is the f32 sum rounded once.  The layers know their
// streams' types only at run time: GemmIn / GemmOut carry a pointer and
// its type, and gemm_gate / gemm_atb on them pick the kernels' instance.
//
// Each file that includes this header gets its own copy of the kernels
// (anonymous namespace): every source builds into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 16;
constexpr int GEMM_TM = 8;
constexpr int GEMM_TN = 8;
constexpr int GEMM_THREADS = (GEMM_BM / GEMM_TM) * (GEMM_BN / GEMM_TN);
constexpr int GEMM_PAD = 4;  // keeps rows 16-byte aligned, spreads banks

// acc += As^T Ws over one staged k tile (both tiles k-major)
__device__ __forceinline__ void gemm_tile_fma(
    const float (*As)[GEMM_BM + GEMM_PAD], const float (*Ws)[GEMM_BN + GEMM_PAD],
    int tx, int ty, float (*acc)[GEMM_TN])
{
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
        float a[GEMM_TM], w[GEMM_TN];
#pragma unroll
        for (int i = 0; i < GEMM_TM; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &As[kk][ty * GEMM_TM + i]);
            a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < GEMM_TN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &Ws[kk][tx * GEMM_TN + j]);
            w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
            for (int j = 0; j < GEMM_TN; ++j)
                acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
}

// C[M, N] = A[M, K] . W[N, K]^T + bias[N] (bias may be null), plus the
// C it finds with ACCUMULATE (a template flag, so the plain product's
// epilogue carries no branch); all row-major, f32 FMA (A and C of type TA
// and TC, f32 or bf16).
template <bool ACCUMULATE, typename TA = float, typename TC = float>
__global__ void __launch_bounds__(GEMM_THREADS)
gate_gemm_kernel(const TA* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, TC* __restrict__ C,
                 int M, int N, int K)
{
    __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + GEMM_PAD];
    __shared__ __align__(16) float Ws[GEMM_BK][GEMM_BN + GEMM_PAD];
    const int tid = threadIdx.x;
    const int tx = tid % (GEMM_BN / GEMM_TN);
    const int ty = tid / (GEMM_BN / GEMM_TN);
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;

    float acc[GEMM_TM][GEMM_TN];
#pragma unroll
    for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
        // stage both tiles k-major; consecutive threads read consecutive k
        for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
            const int r = i / GEMM_BK, c = i % GEMM_BK;
            const int k = k0 + c;
            const int m = m0 + r, n = n0 + r;
            As[c][r] = (m < M && k < K) ? widen(A[(size_t)m * K + k]) : 0.f;
            Ws[c][r] = (n < N && k < K) ? W[(size_t)n * K + k] : 0.f;
        }
        __syncthreads();
        gemm_tile_fma(As, Ws, tx, ty, acc);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < GEMM_TM; ++i) {
        const int m = m0 + ty * GEMM_TM + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) {
            const int n = n0 + tx * GEMM_TN + j;
            if (n < N) {
                float v = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
                if (ACCUMULATE) v += widen(C[(size_t)m * N + n]);
                C[(size_t)m * N + n] = narrow<TC>(v);
            }
        }
    }
}

// C[z, N1, N2] = sum_{k in slice z} A[k, :]^T . B[k + shift, :]; rows of B
// outside [0, K) count as zero.  A [K, N1], B [K, N2] (of type TB, f32 or
// bf16), row-major.
template <typename TB = float>
__global__ void __launch_bounds__(GEMM_THREADS)
atb_gemm_kernel(const float* __restrict__ A, const TB* __restrict__ B,
                float* __restrict__ C, int K, int N1, int N2, int shift,
                int kslice)
{
    __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + GEMM_PAD];
    __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN + GEMM_PAD];
    const int tid = threadIdx.x;
    const int tx = tid % (GEMM_BN / GEMM_TN);
    const int ty = tid / (GEMM_BN / GEMM_TN);
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    const int kbeg = blockIdx.z * kslice;
    const int kend = min(K, kbeg + kslice);

    float acc[GEMM_TM][GEMM_TN];
#pragma unroll
    for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += GEMM_BK) {
        // rows of A and B are contiguous: consecutive threads read
        // consecutive columns of one row
        for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
            const int c = i / GEMM_BM, r = i % GEMM_BM;
            const int k = k0 + c;
            const int kb = k + shift;
            const int m = m0 + r, n = n0 + r;
            As[c][r] = (k < kend && m < N1) ? A[(size_t)k * N1 + m] : 0.f;
            Bs[c][r] = (k < kend && n < N2 && kb >= 0 && kb < K)
                ? widen(B[(size_t)kb * N2 + n]) : 0.f;
        }
        __syncthreads();
        gemm_tile_fma(As, Bs, tx, ty, acc);
        __syncthreads();
    }

    float* Cz = C + (size_t)blockIdx.z * N1 * N2;
#pragma unroll
    for (int i = 0; i < GEMM_TM; ++i) {
        const int m = m0 + ty * GEMM_TM + i;
        if (m >= N1) continue;
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) {
            const int n = n0 + tx * GEMM_TN + j;
            if (n < N2) Cz[(size_t)m * N2 + n] = acc[i][j];
        }
    }
}

// Launch helpers: each returns cudaGetLastError() after its launch.
template <typename TA = float, typename TC = float>
cudaError_t launch_gate_gemm(const TA* A, const float* W, const float* bias,
                             TC* C, int M, int N, int K, cudaStream_t st,
                             bool accumulate = false)
{
    if (M <= 0 || N <= 0) return cudaSuccess;
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    if constexpr (is_bf16<TC>) {
        // a bf16 output is never accumulated onto (d_x)
        if (accumulate) return cudaErrorInvalidValue;
        gate_gemm_kernel<false, TA, TC><<<grid, GEMM_THREADS, 0, st>>>(
            A, W, bias, C, M, N, K);
    } else if (accumulate) {
        gate_gemm_kernel<true, TA, TC><<<grid, GEMM_THREADS, 0, st>>>(
            A, W, bias, C, M, N, K);
    } else {
        gate_gemm_kernel<false, TA, TC><<<grid, GEMM_THREADS, 0, st>>>(
            A, W, bias, C, M, N, K);
    }
    return cudaGetLastError();
}

template <typename TB = float>
cudaError_t launch_atb_gemm(const float* A, const TB* B, float* C, int K,
                            int N1, int N2, int shift, int nsplit,
                            cudaStream_t st)
{
    const int kslice = (K + nsplit - 1) / nsplit;
    dim3 grid((N2 + GEMM_BN - 1) / GEMM_BN, (N1 + GEMM_BM - 1) / GEMM_BM,
              nsplit);
    atb_gemm_kernel<TB><<<grid, GEMM_THREADS, 0, st>>>(A, B, C, K, N1, N2,
                                                       shift, kslice);
    return cudaGetLastError();
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
inline int set_smem(const void* fn, size_t smem)
{
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
}

// -- the plans --------------------------------------------------------------

constexpr int GEMM_SIMT = 0;
constexpr int GEMM_TC = 1;
constexpr int GEMM_PLAN_INTS = 4;

// A GEMM's plan as ops/gemm.py `gemm_plan` gives it (`c_args`): the
// instance, the slices of an atb product's K rows and their length (a
// gate product: 1 and 0), and the persistent CTAs of the tc instance.
struct GemmPlan {
    int instance, nsplit, kslice, ctas;
};

// plan i of an entry point's array of GEMM_PLAN_INTS ints a plan
inline GemmPlan gemm_plan_at(const int* plans, int i)
{
    const int* p = plans + GEMM_PLAN_INTS * i;
    return GemmPlan{p[0], p[1], p[2], p[3]};
}

inline bool gemm_aligned(const void* p)
{
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// whether the tc instance's TMA takes a matrix of rows `inner` elements of
// T long at `p`: 16-byte row strides (4 floats, 8 bf16) and base
template <typename T>
bool gemm_tma_takes(const T* p, int inner)
{
    return inner * sizeof(T) % 16 == 0 && gemm_aligned(p);
}

// the gate product C[M, N] = A[M, K] W[N, K]^T on plan p
template <typename TA>
cudaError_t gate_plan_check(const GemmPlan& p, const TA* A, const float* W,
                            int K)
{
    if (p.nsplit != 1 || p.kslice != 0) return cudaErrorInvalidValue;
    if (p.instance == GEMM_SIMT) return cudaSuccess;
    if (p.instance != GEMM_TC || p.ctas < 1 || !gemm_tma_takes(A, K)
            || !gemm_tma_takes(W, K))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// the atb product of A [K, N1] and B [K, N2] on plan p: nsplit slices of
// kslice rows, none empty (the simt kernel's kslice is ceil(K / nsplit),
// the tc kernel's a multiple of its k tile)
template <typename TB>
cudaError_t atb_plan_check(const GemmPlan& p, const float* A, const TB* B,
                           int K, int N1, int N2)
{
    if (p.nsplit < 1 || p.kslice < 1
            || (long long)p.nsplit * p.kslice < K
            || (K > 0 && (long long)(p.nsplit - 1) * p.kslice >= K))
        return cudaErrorInvalidValue;
    if (p.instance == GEMM_SIMT)
        return p.kslice == max(1, (K + p.nsplit - 1) / p.nsplit)
            ? cudaSuccess : cudaErrorInvalidValue;
    if (p.instance != GEMM_TC || p.ctas < 1 || p.kslice % TC_BK
            || !gemm_tma_takes(A, N1) || !gemm_tma_takes(B, N2))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// the three products after a backward chain on plans gemm[0..2]: d_x
// [M, D] = dx_src [M, G] iwt [D, G]^T, the d_iW partials of dx_src^T x
// [M, D] and the d_sW partials of ds_src^T hp [M, H]
template <typename TX, typename TH>
cudaError_t chain_plans_check(const int* gemm, const float* dx_src,
                              const float* ds_src, const float* iwt,
                              const TX* x, const TH* hp, int M, int G, int D,
                              int H)
{
    cudaError_t err = gate_plan_check(gemm_plan_at(gemm, 0), dx_src, iwt, G);
    if (err == cudaSuccess)
        err = atb_plan_check(gemm_plan_at(gemm, 1), dx_src, x, M, G, D);
    if (err == cudaSuccess)
        err = atb_plan_check(gemm_plan_at(gemm, 2), ds_src, hp, M, G, H);
    return err;
}

// C[M, N] = A W^T (+ bias) (+ C) on its plan's instance
template <typename TA, typename TC>
cudaError_t gemm_gate(const GemmPlan& p, const TA* A, const float* W,
                      const float* bias, TC* C, int M, int N, int K,
                      cudaStream_t st, bool accumulate = false)
{
    if (p.instance == GEMM_TC)
        return tc_gate_gemm(A, W, bias, C, M, N, K, accumulate, p.ctas, st);
    return launch_gate_gemm(A, W, bias, C, M, N, K, st, accumulate);
}

// C[nsplit, N1, N2], the partials of A^T B[. + shift], on its plan's
// instance
template <typename TB>
cudaError_t gemm_atb(const GemmPlan& p, const float* A, const TB* B,
                     float* C, int K, int N1, int N2, int shift,
                     cudaStream_t st)
{
    if (p.instance == GEMM_TC)
        return tc_atb_gemm(A, B, C, K, N1, N2, shift, p.nsplit, p.kslice,
                           p.ctas, st);
    return launch_atb_gemm(A, B, C, K, N1, N2, shift, p.nsplit, st);
}

// -- operands whose type is known at run time -------------------------------

// a matrix operand: f32, or bf16 where `bf16` is set
struct GemmIn {
    const void* p;
    bool bf16;
    const float* f32() const { return static_cast<const float*>(p); }
    const __nv_bfloat16* b16() const
    {
        return static_cast<const __nv_bfloat16*>(p);
    }
};

struct GemmOut {
    void* p;
    bool bf16;
};

inline cudaError_t gate_plan_check(const GemmPlan& p, GemmIn A,
                                   const float* W, int K)
{
    return A.bf16 ? gate_plan_check(p, A.b16(), W, K)
                  : gate_plan_check(p, A.f32(), W, K);
}

inline cudaError_t atb_plan_check(const GemmPlan& p, const float* A,
                                  GemmIn B, int K, int N1, int N2)
{
    return B.bf16 ? atb_plan_check(p, A, B.b16(), K, N1, N2)
                  : atb_plan_check(p, A, B.f32(), K, N1, N2);
}

inline cudaError_t chain_plans_check(const int* gemm, const float* dx_src,
                                     const float* ds_src, const float* iwt,
                                     GemmIn x, GemmIn hp, int M, int G,
                                     int D, int H)
{
    cudaError_t err = gate_plan_check(gemm_plan_at(gemm, 0), dx_src, iwt, G);
    if (err == cudaSuccess)
        err = atb_plan_check(gemm_plan_at(gemm, 1), dx_src, x, M, G, D);
    if (err == cudaSuccess)
        err = atb_plan_check(gemm_plan_at(gemm, 2), ds_src, hp, M, G, H);
    return err;
}

// the gate product with a bf16 A or a bf16 C (not both; a bf16 C is never
// accumulated onto)
inline cudaError_t gemm_gate(const GemmPlan& p, GemmIn A, const float* W,
                             const float* bias, GemmOut C, int M, int N,
                             int K, cudaStream_t st, bool accumulate = false)
{
    if (A.bf16 && C.bf16) return cudaErrorInvalidValue;
    if (A.bf16)
        return gemm_gate(p, A.b16(), W, bias, static_cast<float*>(C.p), M, N,
                         K, st, accumulate);
    if (C.bf16)
        return gemm_gate(p, A.f32(), W, bias, static_cast<__nv_bfloat16*>(C.p), M,
                         N, K, st, accumulate);
    return gemm_gate(p, A.f32(), W, bias, static_cast<float*>(C.p), M, N, K,
                     st, accumulate);
}

inline cudaError_t gemm_atb(const GemmPlan& p, const float* A, GemmIn B,
                            float* C, int K, int N1, int N2, int shift,
                            cudaStream_t st)
{
    return B.bf16 ? gemm_atb(p, A, B.b16(), C, K, N1, N2, shift, st)
                  : gemm_atb(p, A, B.f32(), C, K, N1, N2, shift, st);
}

}  // namespace
