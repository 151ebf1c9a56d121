// Phase probe of the two posterior kernels: the CRF backward (row 6) and
// the logZ posteriors (row 3).  Built by probes/posteriors.py, twice:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//         -Xcompiler -fPIC -Xptxas -v [-DPROBE_LOGZ] -o <lib> \
//         probes/posteriors.cu
//
// It holds the kernels these two rows ran before their redesign
// (csrc/crf.cu `crf_bwd_kernel` and csrc/logz.cu `logz_post_kernel` as of
// commit 667e5cc), copied here unchanged but for two template switches:
//   CLOCK  thread 0 of every block (the CRF) or lane 0 of every row (logZ)
//          adds up the cycles of each phase of a step (clock64), written to
//          cyc[row][phase] at the end;
//   MODE   0 the whole kernel; the CRF: 1 without the shared-memory atomics
//          (the exponentials still summed), 2 the chain alone (the lp-row
//          load, the state update and its one barrier); logZ: 1 the chain
//          alone (the shuffles of bwd, the lse and its group max).
// The phases, CRF: the lp-row load (issue, wait and store to shared
// memory), the position loop (state update, the terms, the next lattice
// row's loads), the first barrier (the max of terms and state), the
// scatter (exponentials and atomics), the second barrier (the sum), the
// grad store.  logZ: the shuffles of bwd, the terms and their group max,
// the exponentials and their group sum, the five divides and stores, the
// chain (lse and group max), the wait for the next row's loads.
// And it exposes the redesigned kernels of csrc/ with their K (steps a
// batch: the CRF's ring of backward vectors; logZ's segment length) set by
// the caller, so that K can be chosen on the card, the CRF's also with its
// own phase clock (BwdClock<true>).

#ifdef PROBE_LOGZ
#include "../taiyaki_tpu_torch/csrc/logz.cu"
#else
#include "../taiyaki_tpu_torch/csrc/crf.cu"
#endif

namespace v1 {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void tick(bool on, long long& t0, long long& acc)
{
    if (on) {
        const long long t = clock64();
        acc += t - t0;
        t0 = t;
    }
}

#ifndef PROBE_LOGZ

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr float NEG = -1e30f;
enum { PH_LOAD, PH_LOOP, PH_MAX, PH_SCATTER, PH_SUM, PH_STORE, NPH };

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

__device__ __forceinline__ float mod_fold(float move, float fact, float mod)
{
    return __fadd_rn(move, __fmul_rn(fact, mod));
}

__device__ __forceinline__ float pick(const float* row, int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? row[idx] : 0.f;
}

template <int P, int MODE, bool CLOCK>
__global__ void __launch_bounds__(THREADS)
crf_bwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const float* __restrict__ lattice,
               const int* __restrict__ valid, const int* __restrict__ lastpos,
               float* __restrict__ grad, int T, int B, int S, int L,
               long long* __restrict__ cyc)
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
    const bool on = CLOCK && tid == 0;
    long long acc[NPH] = {0, 0, 0, 0, 0, 0}, t0 = on ? clock64() : 0;

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
        fc[p] = (in && T > 0 && MODE != 2)
            ? lattice[((size_t)(T - 1) * B + b) * L + l] : NEG;
    }
    const size_t tstride = (size_t)B * S;
    if (tid < S) {
        if (T > 0) lp_s[tid] = lp[(size_t)(T - 1) * tstride + (size_t)b * S + tid];
        bins[tid] = 0.f;
        bins[S + tid] = 0.f;
    }
    __syncthreads();
    if (on) t0 = clock64();

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
        tick(on, t0, acc[PH_LOAD]);
        float fn[P];
        float ts[P], tm[P];
        float mt = NEG, mn = NEG;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * THREADS;
            fn[p] = (l < L && t > 0 && MODE != 2)
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
                    const float move = mod_fold(pick(row, midx[p], S),
                                                mfact[p],
                                                pick(row, mmidx[p], S));
                    const float bs = cur[l + 1] - prev;
                    tm[p] = fc[p] + bs + move;
                    mpart = move + bs;
                }
                nw = logaddexpf_(stay + bn, mpart);
            }
            nxt[l] = nw;
            if (MODE != 2) mt = fmaxf(mt, fmaxf(ts[p], tm[p]));
            mn = fmaxf(mn, nw);
        }
        tick(on, t0, acc[PH_LOOP]);
        if (MODE != 2) mt = warp_max(mt);
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
        tick(on, t0, acc[PH_MAX]);
        if (MODE != 2) {
            float part = 0.f;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const float es = ts[p] > 0.5f * NEG ? expf(ts[p] - tmax) : 0.f;
                const float em = tm[p] > 0.5f * NEG ? expf(tm[p] - tmax) : 0.f;
                if (MODE == 0) {
                    if (es > 0.f && (unsigned)sidx[p] < (unsigned)S)
                        atomicAdd(&bin[sidx[p]], es);
                    if (em > 0.f) {
                        if ((unsigned)midx[p] < (unsigned)S)
                            atomicAdd(&bin[midx[p]], em);
                        if (mfact[p] != 0.f && (unsigned)mmidx[p] < (unsigned)S)
                            atomicAdd(&bin[mmidx[p]], mfact[p] * em);
                    }
                }
                part += es + em;
                fc[p] = fn[p];
            }
            tick(on, t0, acc[PH_SCATTER]);
            part = warp_sum(part);
            if (lane == 0) sums[buf * NWARP + warp] = part;
            __syncthreads();
            tick(on, t0, acc[PH_SUM]);
            if (tid < S) {
                float den = 0.f;
#pragma unroll
                for (int w = 0; w < NWARP; ++w) den += sums[buf * NWARP + w];
                den = den > 0.f ? den : 1.f;
                grad[(size_t)t * tstride + (size_t)b * S + tid] = bin[tid] / den;
                bin[tid] = 0.f;
            }
            tick(on, t0, acc[PH_STORE]);
        }
        prev = factor;
    }
    if (on)
        for (int i = 0; i < NPH; ++i) cyc[(size_t)b * NPH + i] = acc[i];
}

template <int P, int MODE, bool CLOCK>
int launch(const float* lp, const int* sidx, const int* midx,
           const int* mmidx, const float* mfact, const float* lattice,
           const int* valid, const int* last, float* grad, int T, int B,
           int S, int L, long long* cyc, cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 4 * S + 6 * NWARP);
    cudaError_t e = cudaFuncSetAttribute(
        crf_bwd_kernel<P, MODE, CLOCK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    crf_bwd_kernel<P, MODE, CLOCK><<<B, THREADS, smem, st>>>(
        lp, sidx, midx, mmidx, mfact, lattice, valid, last, grad, T, B, S,
        L, cyc);
    return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(int mode, int clock, const float* lp, const int* sidx,
             const int* midx, const int* mmidx, const float* mfact,
             const float* lattice, const int* valid, const int* last,
             float* grad, int T, int B, int S, int L, long long* cyc,
             cudaStream_t st)
{
#define V1_CALL(M, C) launch<P, M, C>(lp, sidx, midx, mmidx, mfact, lattice, \
                                      valid, last, grad, T, B, S, L, cyc, st)
    if (clock) {
        if (mode == 0) return V1_CALL(0, true);
        if (mode == 1) return V1_CALL(1, true);
        return V1_CALL(2, true);
    }
    if (mode == 0) return V1_CALL(0, false);
    if (mode == 1) return V1_CALL(1, false);
    return V1_CALL(2, false);
#undef V1_CALL
}

#else  // PROBE_LOGZ

constexpr int THREADS = 64;
enum { PH_SHFL, PH_TERMS, PH_EXPSUM, PH_STORE, PH_CHAIN, PH_LOAD, NPH };

template <int NFF>
struct Group {
    static constexpr int G = NFF <= 2 ? 2 : NFF <= 4 ? 4 : NFF <= 8 ? 8
                           : NFF <= 16 ? 16 : 32;
};

template <int G>
__device__ __forceinline__ float group_max(float v)
{
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v)
{
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL, v, off);
    return v;
}

template <int N>
__device__ __forceinline__ float lse(const float* c)
{
    float m = -INFINITY;
#pragma unroll
    for (int q = 0; q < N; ++q) m = fmaxf(m, c[q]);
    if (m == -INFINITY) return -INFINITY;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) s += expf(c[q] - m);
    return m + logf(s);
}

template <int NB, int MODE, bool CLOCK>
__global__ void __launch_bounds__(THREADS)
logz_post_kernel(const float* __restrict__ scores,
                 const float* __restrict__ lattice, float* __restrict__ post,
                 int T, int B, long long* __restrict__ cyc)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    constexpr int NOUT = NB + 1;
    const int lane = threadIdx.x & 31;
    const int s = lane & (G - 1);
    const int gbase = lane - s;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool valid = b < B && s < NFF;
    const int flop_lane = gbase + NB + (s < NFF ? s % NB : 0);
    const size_t rowstride = (size_t)B * S;
    const float* srow = scores + (size_t)(valid ? b : 0) * S + s;
    const float* lrow = lattice + (size_t)(valid ? b : 0) * NFF + s;
    const size_t lstride = (size_t)B * NFF;
    const bool on = CLOCK && s == 0 && b < B;
    long long acc[NPH] = {0, 0, 0, 0, 0, 0}, t0 = on ? clock64() : 0;

    float sc[NOUT], nsc[NOUT], fw = -INFINITY, nfw = -INFINITY;
    if (valid && T > 0) {
        const size_t t = T - 1;
#pragma unroll
        for (int q = 0; q < NOUT; ++q) sc[q] = srow[t * rowstride + q * NFF];
        fw = lrow[t * lstride];
    } else {
#pragma unroll
        for (int q = 0; q < NOUT; ++q) sc[q] = -INFINITY;
    }

    float bwd = valid ? -logf((float)NFF) : -INFINITY;
    if (on) t0 = clock64();
    for (int t = T - 1; t >= 0; --t) {
        if (valid && t > 0) {
#pragma unroll
            for (int q = 0; q < NOUT; ++q)
                nsc[q] = srow[(size_t)(t - 1) * rowstride + q * NFF];
            nfw = lrow[(size_t)(t - 1) * lstride];
        } else {
#pragma unroll
            for (int q = 0; q < NOUT; ++q) nsc[q] = -INFINITY;
            nfw = -INFINITY;
        }

        float bd[NOUT];
#pragma unroll
        for (int q = 0; q < NB; ++q) bd[q] = __shfl_sync(FULL, bwd, gbase + q);
        bd[NB] = __shfl_sync(FULL, bwd, flop_lane);
        tick(on, t0, acc[PH_SHFL]);

        float terms[NOUT], out_terms[NOUT];
        float mloc = -INFINITY;
#pragma unroll
        for (int q = 0; q < NOUT; ++q) {
            out_terms[q] = sc[q] + bd[q];
            terms[q] = fw + out_terms[q];
            mloc = fmaxf(mloc, terms[q]);
        }
        if (MODE == 0) {
            const float m = group_max<G>(mloc);
            tick(on, t0, acc[PH_TERMS]);
            float ex[NOUT], part = 0.f;
#pragma unroll
            for (int q = 0; q < NOUT; ++q) {
                ex[q] = m == -INFINITY ? 0.f : expf(terms[q] - m);
                part += ex[q];
            }
            const float den = group_sum<G>(part);
            tick(on, t0, acc[PH_EXPSUM]);
            if (valid) {
                float* prow = post + ((size_t)t * B + b) * S + s;
#pragma unroll
                for (int q = 0; q < NOUT; ++q)
                    prow[q * NFF] = den > 0.f ? ex[q] / den : 0.f;
            }
            tick(on, t0, acc[PH_STORE]);
        }

        const float nw = valid ? lse<NOUT>(out_terms) : -INFINITY;
        const float factor = group_max<G>(nw);
        bwd = factor == -INFINITY ? -INFINITY : nw - factor;
        tick(on, t0, acc[PH_CHAIN]);

#pragma unroll
        for (int q = 0; q < NOUT; ++q) sc[q] = nsc[q];
        fw = nfw;
        if (CLOCK) {
            // force the next row's loads to land here, so that their wait
            // is counted apart
            float x = fw;
#pragma unroll
            for (int q = 0; q < NOUT; ++q) x += sc[q];
            if (x == 1234.5f) bwd += 1e-30f;
        }
        tick(on, t0, acc[PH_LOAD]);
    }
    if (on)
        for (int i = 0; i < NPH; ++i) cyc[(size_t)b * NPH + i] = acc[i];
}

template <int MODE, bool CLOCK>
int launch(const float* scores, const float* lattice, float* post, int T,
           int B, long long* cyc, cudaStream_t st)
{
    constexpr int G = Group<8>::G;
    const int blocks = (int)(((size_t)B * G + THREADS - 1) / THREADS);
    logz_post_kernel<4, MODE, CLOCK><<<blocks, THREADS, 0, st>>>(
        scores, lattice, post, T, B, cyc);
    return static_cast<int>(cudaGetLastError());
}

#endif

}  // namespace v1

extern "C" {

#ifndef PROBE_LOGZ

// the earlier crf_bwd_kernel; mode and clock as in the header (cyc [B][6]).
int probe_crf_bwd_v1(const float* lp, const int* sidx, const int* midx,
                     const int* mmidx, const float* mfact,
                     const float* lattice, const int* valid, const int* last,
                     float* grad, int T, int B, int S, int L, int mode,
                     int clock, long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V1_P(P) v1::launch_p<P>(mode, clock, lp, sidx, midx, mmidx, mfact, \
                                lattice, valid, last, grad, T, B, S, L, cyc, st)
    if (L <= 256) return V1_P(1);
    if (L <= 512) return V1_P(2);
    if (L <= 1024) return V1_P(4);
    if (L <= 2048) return V1_P(8);
    if (L <= 4096) return V1_P(16);
    return static_cast<int>(cudaErrorInvalidValue);
#undef V1_P
}

// the redesigned kernel of csrc/crf.cu with K steps a batch (0: its
// rule); with cyc, its phase clock (cyc [B][BWD_PHASES])
int probe_crf_bwd(const float* lp, const int* sidx, const int* midx,
                  const int* mmidx, const float* mfact, const float* lattice,
                  const int* valid, const int* last, float* grad, int T,
                  int B, int S, int L, int K, long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cyc != nullptr)
        return crf_bwd_dispatch<true>(lp, sidx, midx, mmidx, mfact, lattice,
                                      valid, last, grad, T, B, S, L, K, cyc,
                                      st);
    return crf_bwd_dispatch<false>(lp, sidx, midx, mmidx, mfact, lattice,
                                   valid, last, grad, T, B, S, L, K, nullptr,
                                   st);
}

#else

// the earlier logz_post_kernel at nbase 4; mode and clock as in the header
int probe_logz_post_v1(const float* scores, const float* lattice,
                       float* post, int T, int B, int mode, int clock,
                       long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (clock)
        return mode == 0 ? v1::launch<0, true>(scores, lattice, post, T, B,
                                               cyc, st)
                         : v1::launch<1, true>(scores, lattice, post, T, B,
                                               cyc, st);
    return mode == 0 ? v1::launch<0, false>(scores, lattice, post, T, B, cyc,
                                            st)
                     : v1::launch<1, false>(scores, lattice, post, T, B, cyc,
                                            st);
}

// the redesigned kernels of csrc/logz.cu with segments of K steps (0: its
// rule)
int probe_logz_post(const float* scores, const float* lattice, float* post,
                    int T, int B, int nbase, int K, void* stream)
{
    return logz_post_launch(scores, lattice, post, T, B, nbase, K,
                            static_cast<cudaStream_t>(stream));
}

#endif

}  // extern "C"
