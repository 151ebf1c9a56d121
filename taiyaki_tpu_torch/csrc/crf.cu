// Flip-flop CRF lattice forward and backward for Hopper (sm_90a), f32.
//
// Replaces the TPU kernels taiyaki_tpu/ops/pallas_crf.py:423
// `crf_forward_fused` (tt_crf_fwd) and pallas_crf.py:565
// `crf_backward_fused` (tt_crf_bwd), with their contract: transition
// scores lp [T, B, S] and per-row index vectors [B, L] in; the final
// forward vector, the summed renormalisers and the forward lattice out of
// the forward; d(score)/d(lp) [T, B, S] out of the backward.
//
// The lattice of row b has L positions.  Position l holds stay score
// lp[t, b, stay_idx[b, l]] and the move from l to l+1 scores
// lp[t, b, move_idx[b, l]] + modmove_fact[b, l] * lp[t, b, modmove_idx[b, l]]
// (the weighted cat_mod column; the fact is 0 for canonical models).  An
// index outside [0, S) selects 0.  valid[b, l] masks positions past the
// row's sequence.  Impossible states hold NEG = -1e30, as in the JAX
// package, so a row with no path keeps finite values and gives zero
// posteriors.
//
// Forward, per step: new[l] = logaddexp(fwd[l] + stay[l],
// fwd[l-1] + move[l-1]), masked, renormalised by its max over l; score
// accumulates the maxima; lattice[t] is fwd before the step.
// Backward, per step from T-1 down: the posterior over the 2L-1
// transitions is the softmax of fwd[t][l] + bwd[l] + stay[l] and
// fwd[t][l] + bwd[l+1] + move[l] (moves only for l < last), scattered into
// the S columns of d lp[t, b]; bwd steps back as
// logaddexp(stay[l] + bwd[l], move[l] + bwd[l+1]), renormalised by its max.
//
// The TPU kernels select scores with one-hot matrix products because
// gathers were slow there (ops/flipflop.py:146-153); here lp[t, b, :]
// (S floats) is staged in shared memory each step and indexed directly
// with the indices each thread holds in registers.
//
// Layout: one block of 256 threads per batch row, P positions per thread
// (l = tid + p*256, P in 1, 2, 4, 8, 16, 32 by L, so L <= 8192; the
// mGru default chunk range needs L <= 3637, P = 16).  The per-position
// indices stay in registers; at P = 32 they outgrow the 255 a thread may
// hold and the compiler spills the rest to local memory (cached in L1),
// which costs time, not correctness.  The state vector lives in
// shared memory, double-buffered and stored before renormalisation: the
// step's max is only known after a block-wide reduction, and the next step
// subtracts it when it reads the vector, so each forward step needs one
// barrier.  The backward needs two: the max of the terms (with the max of
// the new state) and then the sum of the exponentials.  Its scatter of
// posteriors into S bins uses shared-memory atomics on unnormalised
// exponentials (exact zeros skipped), divided by the sum afterwards; the
// order of those float additions varies from run to run.
//
// Shared memory: 2L + a few dozen floats, 64 KB at L = 8192, under the
// 227 KB a block may use.
//
// Bound: the serial chain of T steps of a few hundred cycles each (loads,
// block reductions, exp/log), not bytes: at T=800, B=256, L=512 the lattice
// is 0.42 GB, ~0.13 ms of device-memory time, while the chain is
// milliseconds.  B blocks run side by side, so B >= 132 fills the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr int MAX_S = 128;

__device__ __forceinline__ float logaddexpf_(float a, float b)
{
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float warp_max(float v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// score of column idx in the staged row (0 outside [0, S))
__device__ __forceinline__ float pick(const float* row, int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? row[idx] : 0.f;
}

template <int P>
__global__ void __launch_bounds__(THREADS)
crf_fwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const int* __restrict__ valid, float* __restrict__ fwd_final,
               float* __restrict__ score_out, float* __restrict__ lattice,
               int T, int B, int S, int L)
{
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* lp_s = smem + 2 * L;                // [2][S]
    float* red = lp_s + 2 * S;                 // [2][NWARP]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    const size_t rowoff = (size_t)b * L;

    // per position: stay column, the move into it (from l-1), validity
    int sidx[P], midx[P], mmidx[P];
    float mfact[P];
    bool ok[P], mok[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * THREADS;
        const bool in = l < L;
        sidx[p] = in ? stay_idx[rowoff + l] : S;
        midx[p] = (in && l > 0) ? move_idx[rowoff + l - 1] : S;
        mmidx[p] = (in && l > 0) ? mod_idx[rowoff + l - 1] : S;
        mfact[p] = (in && l > 0) ? mod_fact[rowoff + l - 1] : 0.f;
        ok[p] = in && valid[rowoff + l] != 0;
        mok[p] = ok[p] && l > 0 && valid[rowoff + l - 1] != 0;
        if (in) state[l] = (l == 0 && ok[p]) ? 0.f : NEG;
    }
    const size_t tstride = (size_t)B * S;
    if (tid < S && T > 0) lp_s[tid] = lp[(size_t)b * S + tid];
    __syncthreads();

    float prev = 0.f, score = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* cur = state + (t & 1) * L;
        float* nxt = state + ((t + 1) & 1) * L;
        const float* row = lp_s + (t & 1) * S;
        if (tid < S && t + 1 < T)
            lp_s[((t + 1) & 1) * S + tid] =
                lp[(size_t)(t + 1) * tstride + (size_t)b * S + tid];
        float m = NEG;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * THREADS;
            if (l >= L) continue;
            const float f = ok[p] ? cur[l] - prev : NEG;
            if (lattice != nullptr)
                lattice[((size_t)t * B + b) * L + l] = f;
            float nw = NEG;
            if (ok[p]) {
                const float stay = f + pick(row, sidx[p], S);
                float move = NEG;
                if (mok[p]) {
                    const float sc = pick(row, midx[p], S)
                        + mfact[p] * pick(row, mmidx[p], S);
                    move = (cur[l - 1] - prev) + sc;
                }
                nw = logaddexpf_(stay, move);
            }
            nxt[l] = nw;
            m = fmaxf(m, nw);
        }
        m = warp_max(m);
        if (lane == 0) red[(t & 1) * NWARP + warp] = m;
        __syncthreads();
        float factor = red[(t & 1) * NWARP];
#pragma unroll
        for (int w = 1; w < NWARP; ++w)
            factor = fmaxf(factor, red[(t & 1) * NWARP + w]);
        score += factor;
        prev = factor;
    }
    const float* last = state + (T & 1) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * THREADS;
        if (l < L) fwd_final[rowoff + l] = ok[p] ? last[l] - prev : NEG;
    }
    if (tid == 0) score_out[b] = score;
}

template <int P>
__global__ void __launch_bounds__(THREADS)
crf_bwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const float* __restrict__ lattice,
               const int* __restrict__ valid, const int* __restrict__ lastpos,
               float* __restrict__ grad, int T, int B, int S, int L)
{
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* lp_s = smem + 2 * L;                // [2][S]
    float* bins = lp_s + 2 * S;                // [2][S]
    float* red = bins + 2 * S;                 // [2][2][NWARP]
    float* sums = red + 4 * NWARP;             // [2][NWARP]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    const size_t rowoff = (size_t)b * L;
    const int last = lastpos[b];

    // per position: stay column, the move out of it (to l+1), validity
    int sidx[P], midx[P], mmidx[P];
    float mfact[P], fc[P];
    bool ok[P], mok[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * THREADS;
        const bool in = l < L;
        sidx[p] = in ? stay_idx[rowoff + l] : S;
        midx[p] = in ? move_idx[rowoff + l] : S;
        mmidx[p] = in ? mod_idx[rowoff + l] : S;
        mfact[p] = in ? mod_fact[rowoff + l] : 0.f;
        ok[p] = in && valid[rowoff + l] != 0;
        mok[p] = ok[p] && l < last && l + 1 < L
            && valid[rowoff + l + 1] != 0;
        if (in) state[l] = (l == last && ok[p]) ? 0.f : NEG;
        fc[p] = (in && T > 0)
            ? lattice[((size_t)(T - 1) * B + b) * L + l] : NEG;
    }
    const size_t tstride = (size_t)B * S;
    if (tid < S) {
        if (T > 0) lp_s[tid] = lp[(size_t)(T - 1) * tstride + (size_t)b * S + tid];
        bins[tid] = 0.f;
        bins[S + tid] = 0.f;
    }
    __syncthreads();

    float prev = 0.f;
    for (int s = 0; s < T; ++s) {
        const int t = T - 1 - s;
        const int buf = s & 1;
        const float* cur = state + buf * L;
        float* nxt = state + (buf ^ 1) * L;
        const float* row = lp_s + buf * S;
        float* bin = bins + buf * S;
        if (tid < S && t > 0)
            lp_s[(buf ^ 1) * S + tid] =
                lp[(size_t)(t - 1) * tstride + (size_t)b * S + tid];
        float fn[P];
        float ts[P], tm[P];
        float mt = NEG, mn = NEG;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * THREADS;
            fn[p] = (l < L && t > 0)
                ? lattice[((size_t)(t - 1) * B + b) * L + l] : NEG;
            ts[p] = NEG;
            tm[p] = NEG;
            if (l >= L) continue;
            float nw = NEG;
            if (ok[p]) {
                const float bn = cur[l] - prev;
                const float stay = pick(row, sidx[p], S);
                ts[p] = fc[p] + bn + stay;
                float mpart = NEG;
                if (mok[p]) {
                    const float move = pick(row, midx[p], S)
                        + mfact[p] * pick(row, mmidx[p], S);
                    mpart = move + (cur[l + 1] - prev);
                    tm[p] = fc[p] + mpart;
                }
                nw = logaddexpf_(stay + bn, mpart);
            }
            nxt[l] = nw;
            mt = fmaxf(mt, fmaxf(ts[p], tm[p]));
            mn = fmaxf(mn, nw);
        }
        mt = warp_max(mt);
        mn = warp_max(mn);
        if (lane == 0) {
            red[buf * 2 * NWARP + warp] = mt;
            red[buf * 2 * NWARP + NWARP + warp] = mn;
        }
        __syncthreads();
        float tmax = red[buf * 2 * NWARP], factor = red[buf * 2 * NWARP + NWARP];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) {
            tmax = fmaxf(tmax, red[buf * 2 * NWARP + w]);
            factor = fmaxf(factor, red[buf * 2 * NWARP + NWARP + w]);
        }
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const float es = ts[p] > 0.5f * NEG ? expf(ts[p] - tmax) : 0.f;
            const float em = tm[p] > 0.5f * NEG ? expf(tm[p] - tmax) : 0.f;
            if (es > 0.f && (unsigned)sidx[p] < (unsigned)S)
                atomicAdd(&bin[sidx[p]], es);
            if (em > 0.f) {
                if ((unsigned)midx[p] < (unsigned)S)
                    atomicAdd(&bin[midx[p]], em);
                if (mfact[p] != 0.f && (unsigned)mmidx[p] < (unsigned)S)
                    atomicAdd(&bin[mmidx[p]], mfact[p] * em);
            }
            part += es + em;
            fc[p] = fn[p];
        }
        part = warp_sum(part);
        if (lane == 0) sums[buf * NWARP + warp] = part;
        __syncthreads();
        if (tid < S) {
            float den = 0.f;
#pragma unroll
            for (int w = 0; w < NWARP; ++w) den += sums[buf * NWARP + w];
            den = den > 0.f ? den : 1.f;
            grad[(size_t)t * tstride + (size_t)b * S + tid] = bin[tid] / den;
            bin[tid] = 0.f;
        }
        prev = factor;
    }
}

template <int P>
size_t fwd_smem(int S, int L) { return sizeof(float) * (2 * L + 2 * S + 2 * NWARP); }

template <int P>
size_t bwd_smem(int S, int L)
{
    return sizeof(float) * (2 * L + 4 * S + 6 * NWARP);
}

template <int P>
int launch_fwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const int* valid,
               float* fwd_final, float* score, float* lattice, int T, int B,
               int S, int L, cudaStream_t st)
{
    const size_t smem = fwd_smem<P>(S, L);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_fwd_kernel<P><<<B, THREADS, smem, st>>>(lp, sidx, midx, mmidx, mfact,
                                                valid, fwd_final, score,
                                                lattice, T, B, S, L);
    return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_bwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const float* lattice,
               const int* valid, const int* last, float* grad, int T, int B,
               int S, int L, cudaStream_t st)
{
    const size_t smem = bwd_smem<P>(S, L);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_bwd_kernel<P><<<B, THREADS, smem, st>>>(lp, sidx, midx, mmidx, mfact,
                                                lattice, valid, last, grad,
                                                T, B, S, L);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TT_P_CASES(CALL)                                        \
    if (L <= THREADS) return CALL(1);                           \
    if (L <= 2 * THREADS) return CALL(2);                       \
    if (L <= 4 * THREADS) return CALL(4);                       \
    if (L <= 8 * THREADS) return CALL(8);                       \
    if (L <= 16 * THREADS) return CALL(16);                     \
    if (L <= 32 * THREADS) return CALL(32);                     \
    return static_cast<int>(cudaErrorInvalidValue);

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp [T, B, S]; stay/move/mod idx, valid [B, L] int32; mod_fact [B, L];
// -> fwd_final [B, L], score [B] (the summed renormalisers; the caller
// adds fwd_final at the row's last position), lattice [T, B, L] (may be
// null).  Returns cudaGetLastError().
int tt_crf_fwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const int* valid,
               float* fwd_final, float* score, float* lattice, int T, int B,
               int S, int L, void* stream)
{
    if (B == 0 || L == 0) return 0;
    if (S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_FWD(P) launch_fwd<P>(lp, sidx, midx, mmidx, mfact, valid, \
                                fwd_final, score, lattice, T, B, S, L, st)
    TT_P_CASES(TT_FWD)
#undef TT_FWD
}

// ... + lattice [T, B, L] of tt_crf_fwd, last [B] int32 -> grad [T, B, S].
int tt_crf_bwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const float* lattice,
               const int* valid, const int* last, float* grad, int T, int B,
               int S, int L, void* stream)
{
    if (B == 0 || T == 0) return 0;
    if (S > MAX_S || L == 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_BWD(P) launch_bwd<P>(lp, sidx, midx, mmidx, mfact, lattice, \
                                valid, last, grad, T, B, S, L, st)
    TT_P_CASES(TT_BWD)
#undef TT_BWD
}

}  // extern "C"
