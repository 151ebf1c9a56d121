// Phase probe of the two forward kernels: the CRF forward (row 5) and the
// logZ forward (row 2).  Built by probes/forward.py, twice:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//         -Xcompiler -fPIC -Xptxas -v [-DPROBE_LOGZ] -o <lib> \
//         probes/forward.cu
//
// It holds the kernels these two rows ran before their redesign
// (csrc/crf.cu `crf_fwd_kernel<P>` and csrc/logz.cu `logz_fwd_kernel<NB>`
// as of commit f29b85e), copied here unchanged but for a phase clock
// (CLOCK): thread 0 of every block (the CRF) or lane 0 of every row (logZ)
// adds up the cycles of each phase of a step (clock64), written to
// cyc[row][phase] at the end.  The phases, CRF: the lp-row load (its
// issue, the wait for it and the store to shared memory), the position
// loop (the state update and the lattice stores), the barrier and the
// block max.  logZ: the lattice store and the state's shuffles, the lse,
// the group max, sum and log.
// And it exposes the redesigned kernels of csrc/: the CRF forward in every
// layout instantiated below (threads a row, positions a thread, CTAs a
// row; accurate or fast exponentials), its steps a batch, and its own phase
// clock (PhaseClock, on the layouts of csrc/crf.cu's bands); the logZ
// forward at a segment length K set by the caller.

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
enum { PH_LOAD, PH_LOOP, PH_MAX, NPH };

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

__device__ __forceinline__ float mod_fold(float move, float fact, float mod)
{
    return __fadd_rn(move, __fmul_rn(fact, mod));
}

__device__ __forceinline__ float pick(const float* row, int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? row[idx] : 0.f;
}

template <int P, bool CLOCK>
__global__ void __launch_bounds__(THREADS)
crf_fwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const int* __restrict__ valid, float* __restrict__ fwd_final,
               float* __restrict__ score_out, float* __restrict__ lattice,
               int T, int B, int S, int L, long long* __restrict__ cyc)
{
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* lp_s = smem + 2 * L;                // [2][S]
    float* red = lp_s + 2 * S;                 // [2][NWARP]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    const size_t rowoff = (size_t)b * L;
    const bool on = CLOCK && tid == 0;
    long long acc[NPH] = {0, 0, 0}, t0 = 0;

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
    if (on) t0 = clock64();

    float prev = 0.f, score = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* cur = state + (t & 1) * L;
        float* nxt = state + ((t + 1) & 1) * L;
        const float* row = lp_s + (t & 1) * S;
        if (tid < S && t + 1 < T)
            lp_s[((t + 1) & 1) * S + tid] =
                lp[(size_t)(t + 1) * tstride + (size_t)b * S + tid];
        tick(on, t0, acc[PH_LOAD]);
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
                    const float sc = mod_fold(pick(row, midx[p], S),
                                              mfact[p],
                                              pick(row, mmidx[p], S));
                    move = (cur[l - 1] - prev) + sc;
                }
                nw = logaddexpf_(stay, move);
            }
            nxt[l] = nw;
            m = fmaxf(m, nw);
        }
        tick(on, t0, acc[PH_LOOP]);
        m = warp_max(m);
        if (lane == 0) red[(t & 1) * NWARP + warp] = m;
        __syncthreads();
        float factor = red[(t & 1) * NWARP];
#pragma unroll
        for (int w = 1; w < NWARP; ++w)
            factor = fmaxf(factor, red[(t & 1) * NWARP + w]);
        score += factor;
        prev = factor;
        tick(on, t0, acc[PH_MAX]);
    }
    const float* last = state + (T & 1) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * THREADS;
        if (l < L) fwd_final[rowoff + l] = ok[p] ? last[l] - prev : NEG;
    }
    if (tid == 0) score_out[b] = score;
    if (on)
        for (int i = 0; i < NPH; ++i) cyc[b * NPH + i] = acc[i];
}

template <int P, bool CLOCK>
int launch(const float* lp, const int* sidx, const int* midx,
           const int* mmidx, const float* mfact, const int* valid,
           float* fwd_final, float* score, float* lattice, int T, int B,
           int S, int L, long long* cyc, cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 2 * S + 2 * NWARP);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_fwd_kernel<P, CLOCK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_fwd_kernel<P, CLOCK><<<B, THREADS, smem, st>>>(
        lp, sidx, midx, mmidx, mfact, valid, fwd_final, score, lattice, T,
        B, S, L, cyc);
    return static_cast<int>(cudaGetLastError());
}

#else  // PROBE_LOGZ

constexpr int THREADS = 64;
enum { PH_SHFL, PH_LSE, PH_NORM, NPH };

template <int G>
__device__ __forceinline__ float group_sum(float v)
{
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL, v, off);
    return v;
}

template <int NB, bool CLOCK>
__global__ void __launch_bounds__(THREADS)
logz_fwd_kernel(const float* __restrict__ scores, float* __restrict__ fwd_final,
                float* __restrict__ logz_out, float* __restrict__ lattice,
                int T, int B, long long* __restrict__ cyc)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    const int lane = threadIdx.x & 31;
    const int d = lane & (G - 1);
    const int gbase = lane - d;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool valid = b < B && d < NFF;
    const bool flip = d < NB;
    const bool on = CLOCK && valid && d == 0;
    long long acc[NPH] = {0, 0, 0}, t0 = on ? clock64() : 0;
    // columns entering state d: flip d from every source (NFF of them),
    // flop d from flip d-NB and from itself (2)
    const int base = flip ? d * NFF : NFF * NB + d - NB;
    const int step = flip ? 1 : NB;
    const int nin = valid ? (flip ? NFF : 2) : 0;
    const int src_lane = gbase + (flip ? d : d - NB);
    const size_t rowstride = (size_t)B * S;
    const float* row = scores + (size_t)(valid ? b : 0) * S + base;

    float sc[NFF], nx[NFF];
#pragma unroll
    for (int q = 0; q < NFF; ++q)
        sc[q] = (q < nin && T > 0) ? row[q * step] : -INFINITY;

    float fwd = valid && flip ? -logf((float)NB) : -INFINITY;
    float logz = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* nrow = row + (size_t)(t + 1) * rowstride;
#pragma unroll
        for (int q = 0; q < NFF; ++q)
            nx[q] = (q < nin && t + 1 < T) ? nrow[q * step] : -INFINITY;
        if (lattice != nullptr && valid)
            lattice[((size_t)t * B + b) * NFF + d] = fwd;

        float f[NFF];
#pragma unroll
        for (int q = 0; q < NFF; ++q) f[q] = __shfl_sync(FULL, fwd, gbase + q);
        const float from_flip = __shfl_sync(FULL, fwd, src_lane);
        tick(on, t0, acc[PH_SHFL]);
        float cand[NFF];
#pragma unroll
        for (int q = 0; q < NFF; ++q) {
            const float fs = flip ? f[q]
                : (q == 0 ? from_flip : (q == 1 ? fwd : -INFINITY));
            cand[q] = fs + sc[q];
        }
        const float nw = valid ? lse<NFF>(cand) : -INFINITY;
        tick(on, t0, acc[PH_LSE]);
        const float m = group_max<G>(nw);
        const float sum = group_sum<G>(m == -INFINITY ? 0.f : expf(nw - m));
        const float factor = m == -INFINITY ? -INFINITY : m + logf(sum);
        fwd = factor == -INFINITY ? -INFINITY : nw - factor;
        logz += factor;
#pragma unroll
        for (int q = 0; q < NFF; ++q) sc[q] = nx[q];
        tick(on, t0, acc[PH_NORM]);
    }
    if (valid) {
        fwd_final[(size_t)b * NFF + d] = fwd;
        if (d == 0) logz_out[b] = logz;
    }
    if (on)
        for (int i = 0; i < NPH; ++i) cyc[b * NPH + i] = acc[i];
}

#endif  // PROBE_LOGZ

}  // namespace v1

extern "C" {

#ifndef PROBE_LOGZ

// the first design (v1) at L's P; with clock, cyc [B][3]
int probe_crf_fwd_v1(const float* lp, const int* sidx, const int* midx,
                     const int* mmidx, const float* mfact, const int* valid,
                     float* fwd_final, float* score, float* lattice, int T,
                     int B, int S, int L, int clock, long long* cyc,
                     void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V1(P) (clock ? v1::launch<P, true>(lp, sidx, midx, mmidx, mfact,  \
                                           valid, fwd_final, score,       \
                                           lattice, T, B, S, L, cyc, st)  \
                     : v1::launch<P, false>(lp, sidx, midx, mmidx, mfact, \
                                            valid, fwd_final, score,      \
                                            lattice, T, B, S, L, cyc, st))
    if (L <= 256) return V1(1);
    if (L <= 512) return V1(2);
    if (L <= 1024) return V1(4);
    if (L <= 2048) return V1(8);
    if (L <= 4096) return V1(16);
    if (L <= 8192) return V1(32);
#undef V1
    return static_cast<int>(cudaErrorInvalidValue);
}

// the redesign in layout (NT threads a row, P positions a thread, CL CTAs
// a row), fast exponentials or not, K steps of lp rows a batch; refused
// (cudaErrorInvalidValue) for a layout not instantiated here or narrower
// than L.  NT = 0: csrc/crf.cu's own band for L, with its phase clock
// into cyc [B][FWD_PHASES] where cyc is not null.
int probe_crf_fwd(const float* lp, const int* sidx, const int* midx,
                  const int* mmidx, const float* mfact, const int* valid,
                  float* fwd_final, float* score, float* lattice, int T,
                  int B, int S, int L, int NT, int P, int CL, int fast,
                  int K, long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 0) K = FWD_BATCH;
    if (NT == 0)
        return cyc != nullptr
            ? crf_fwd_dispatch<false, true>(lp, sidx, midx, mmidx, mfact,
                                            valid, fwd_final, score, lattice,
                                            T, B, S, L, K, cyc, st)
            : crf_fwd_dispatch<false, false>(lp, sidx, midx, mmidx, mfact,
                                             valid, fwd_final, score,
                                             lattice, T, B, S, L, K, nullptr,
                                             st);
#define V(nt, p, cl, f)                                                     \
    if (NT == nt && P == p && CL == cl && fast == f)                        \
        return launch_fwd<nt, p, cl, f, false>(lp, sidx, midx, mmidx, mfact, \
                                               valid, fwd_final, score,      \
                                               lattice, T, B, S, L, K, nt,   \
                                               nullptr, st);
    V(32, 4, 1, 0) V(32, 8, 1, 0) V(32, 16, 1, 0)
    V(64, 4, 1, 0) V(64, 8, 1, 0)
    V(128, 2, 1, 0) V(128, 4, 1, 0) V(128, 8, 1, 0)
    V(256, 1, 1, 0) V(256, 2, 1, 0) V(256, 4, 1, 0) V(256, 8, 1, 0)
    V(512, 1, 1, 0) V(512, 2, 1, 0) V(512, 4, 1, 0) V(512, 8, 1, 0)
    V(512, 16, 1, 0) V(512, 16, 1, 1)
    V(1024, 2, 1, 0) V(1024, 4, 1, 0) V(1024, 8, 1, 0)
    V(256, 8, 2, 0) V(512, 4, 2, 0) V(512, 8, 2, 0) V(1024, 2, 2, 0)
    V(1024, 4, 2, 0)
    V(32, 16, 1, 1) V(64, 8, 1, 1) V(128, 4, 1, 1) V(256, 2, 1, 1)
    V(512, 1, 1, 1) V(256, 4, 1, 1) V(512, 2, 1, 1) V(1024, 4, 1, 1)
    V(512, 4, 2, 1) V(1024, 2, 2, 1) V(1024, 8, 1, 1) V(512, 8, 2, 1)
    V(1024, 4, 2, 1)
#undef V
    return static_cast<int>(cudaErrorInvalidValue);
}

#else  // PROBE_LOGZ

// the first design (v1), nbase 4; with clock, cyc [B][3]
int probe_logz_fwd_v1(const float* scores, float* fwd_final, float* logz,
                      float* lattice, int T, int B, int clock,
                      long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    constexpr int G = Group<8>::G;
    const int blocks = (int)(((size_t)B * G + v1::THREADS - 1) / v1::THREADS);
    if (clock)
        v1::logz_fwd_kernel<4, true><<<blocks, v1::THREADS, 0, st>>>(
            scores, fwd_final, logz, lattice, T, B, cyc);
    else
        v1::logz_fwd_kernel<4, false><<<blocks, v1::THREADS, 0, st>>>(
            scores, fwd_final, logz, lattice, T, B, cyc);
    return static_cast<int>(cudaGetLastError());
}

// the floats of the redesign's scratch at segments of K steps
int probe_logz_fwd_scratch(int T, int B, int nbase, int K)
{
    return (int)FwdScratch(B, 2 * nbase, T > K ? (T + K - 1) / K : 1)
        .floats;
}

// the redesign at segments of K steps (K <= 0: its rule)
int probe_logz_fwd(const float* scores, float* fwd_final, float* logz,
                   float* lattice, float* scratch, int T, int B, int nbase,
                   int K, void* stream)
{
    return logz_fwd_launch(scores, fwd_final, logz, lattice, scratch, T, B,
                           nbase, K, static_cast<cudaStream_t>(stream));
}

#endif  // PROBE_LOGZ

}  // extern "C"
