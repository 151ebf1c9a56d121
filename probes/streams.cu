// Phase probe of the CRF on score streams: the forward (row 9,
// crf_fwd_streams) and the backward (row 10, crf_bwd_posteriors and the
// route's d lp, crf_grad_streams).  Built by probes/streams.py:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//         -Xcompiler -fPIC -Xptxas -v -o <lib> probes/streams.cu
//
// It holds the kernels these two rows ran before their redesign
// (csrc/crf.cu `crf_fwd_streams_kernel<NT, P>`,
// `crf_bwd_posteriors_kernel<NT, P>` and their device-memory instances
// past 16384 positions, as of commit 3a0ee40), copied here unchanged but
// for a phase clock (CLOCK): thread 0 of every block adds up the cycles of
// each phase of a step (clock64), written to cyc[row][phase] at the end.
// The phases, forward: the positions (state update and lattice stores),
// the barrier and block max, the wait for the next step's stream rows
// (forced by reading their registers).  Backward: the positions (state
// update and the posterior terms), the first barrier (term and state
// maxima), the posterior exponentials and their sum, the second barrier
// (the sum), the posterior stores, the stream wait.  The device-memory
// instances: the positions (streams read at the step), the barrier(s),
// the posterior pass and its division (backward).
// And it exposes the redesigns of csrc/crf.cu: the forward and backward
// chains in every layout instantiated below (threads a row, positions a
// thread, CTAs a row), at ring depth K, and the posterior pass.

#include "../taiyaki_tpu_torch/csrc/crf.cu"

namespace v1 {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr int MAX_L_SMEM = 16384;
constexpr int GMEM_NT = 1024;
enum { F_POS, F_BAR, F_WAIT, F_NPH };
enum { B_POS, B_BAR1, B_EXP, B_BAR2, B_STORE, B_WAIT, B_NPH };

__device__ __forceinline__ void tick(bool on, long long& t0, long long& acc)
{
    if (on) {
        const long long t = clock64();
        acc += t - t0;
        t0 = t;
    }
}

// the registers' values are needed here: waits for their loads
__device__ __forceinline__ void use(float v)
{
    asm volatile("" :: "f"(v));
}

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

template <int NT>
__device__ __forceinline__ float block_max(float v, float* red, int lane,
                                           int warp)
{
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
    return m;
}

template <int NT, int P, bool CLOCK>
__global__ void __launch_bounds__(NT)
crf_fwd_streams_kernel(const float* __restrict__ stay,
                       const float* __restrict__ move,
                       const int* __restrict__ valid,
                       float* __restrict__ fwd_final,
                       float* __restrict__ score_out,
                       float* __restrict__ lattice, int T, int B, int L,
                       long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* red = smem + 2 * L;                 // [2][NW]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    const bool on = CLOCK && tid == 0;
    long long t0 = 0, acc[F_NPH] = {};

    bool ok[P];
    float st[P], mv[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * NT;
        ok[p] = l < L && valid[row + l] != 0;
        if (l < L) state[l] = (l == 0 && ok[p]) ? 0.f : NEG;
        st[p] = (ok[p] && T > 0) ? stay[row + l] : 0.f;
        mv[p] = (ok[p] && l > 0 && T > 0) ? move[row + l - 1] : 0.f;
    }
    __syncthreads();
    if (CLOCK) t0 = clock64();

    float prev = 0.f, score = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* cur = state + (t & 1) * L;
        float* nxt = state + ((t + 1) & 1) * L;
        const size_t off = (size_t)(t + 1) * tstride + row;
        float nst[P], nmv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * NT;
            const bool more = ok[p] && t + 1 < T;
            nst[p] = more ? stay[off + l] : 0.f;
            nmv[p] = (more && l > 0) ? move[off + l - 1] : 0.f;
        }
        float m = NEG;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * NT;
            if (l < L) {
                const float f = ok[p] ? cur[l] - prev : NEG;
                if (lattice != nullptr)
                    lattice[(size_t)t * tstride + row + l] = f;
                float nw = NEG;
                if (ok[p]) {
                    const float mpart =
                        l > 0 ? (cur[l - 1] - prev) + mv[p] : NEG;
                    nw = logaddexpf_(f + st[p], mpart);
                }
                nxt[l] = nw;
                m = fmaxf(m, nw);
            }
            st[p] = nst[p];
            mv[p] = nmv[p];
        }
        tick(on, t0, acc[F_POS]);
        prev = block_max<NT>(m, red + (t & 1) * NW, lane, warp);
        score += prev;
        tick(on, t0, acc[F_BAR]);
        if (CLOCK) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                use(st[p]);
                use(mv[p]);
            }
        }
        tick(on, t0, acc[F_WAIT]);
    }
    const float* fin = state + (T & 1) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * NT;
        if (l < L) fwd_final[row + l] = ok[p] ? fin[l] - prev : NEG;
    }
    if (tid == 0) score_out[blockIdx.x] = score;
    if (on)
        for (int i = 0; i < F_NPH; ++i) cyc[blockIdx.x * F_NPH + i] = acc[i];
}

template <int NT, int P, bool CLOCK>
__global__ void __launch_bounds__(NT)
crf_bwd_posteriors_kernel(const float* __restrict__ stay,
                          const float* __restrict__ move,
                          const float* __restrict__ lattice,
                          const int* __restrict__ valid,
                          const int* __restrict__ lastpos,
                          float* __restrict__ post_stay,
                          float* __restrict__ post_move, int T, int B, int L,
                          long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* red = smem + 2 * L;                 // [2][2][NW] term and state max
    float* sums = red + 4 * NW;                // [2][NW]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    const int last = lastpos[blockIdx.x];
    const bool on = CLOCK && tid == 0;
    long long t0 = 0, acc[B_NPH] = {};

    bool ok[P], mok[P];
    float st[P], mv[P], fc[P];
    const size_t off0 = (size_t)(T > 0 ? T - 1 : 0) * tstride + row;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * NT;
        ok[p] = l < L && valid[row + l] != 0;
        mok[p] = ok[p] && l < last;
        if (l < L) state[l] = (l == last && ok[p]) ? 0.f : NEG;
        st[p] = (ok[p] && T > 0) ? stay[off0 + l] : 0.f;
        mv[p] = (mok[p] && T > 0) ? move[off0 + l] : 0.f;
        fc[p] = (ok[p] && T > 0) ? lattice[off0 + l] : NEG;
    }
    __syncthreads();
    if (CLOCK) t0 = clock64();

    float prev = 0.f;
    for (int s = 0; s < T; ++s) {
        const int t = T - 1 - s;
        const int buf = s & 1;
        const float* cur = state + buf * L;
        float* nxt = state + (buf ^ 1) * L;
        const size_t off = (size_t)(t > 0 ? t - 1 : 0) * tstride + row;
        float nst[P], nmv[P], nfc[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * NT;
            const bool more = ok[p] && t > 0;
            nst[p] = more ? stay[off + l] : 0.f;
            nmv[p] = (more && mok[p]) ? move[off + l] : 0.f;
            nfc[p] = more ? lattice[off + l] : NEG;
        }
        float ts[P], tm[P];
        float mt = NEG, mn = NEG;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * NT;
            ts[p] = NEG;
            tm[p] = NEG;
            if (l < L) {
                float nw = NEG;
                if (ok[p]) {
                    const float bn = cur[l] - prev;
                    ts[p] = fc[p] + bn + st[p];
                    float mpart = NEG;
                    if (mok[p]) {
                        const float bs = cur[l + 1] - prev;
                        tm[p] = fc[p] + bs + mv[p];
                        mpart = mv[p] + bs;
                    }
                    nw = logaddexpf_(st[p] + bn, mpart);
                }
                nxt[l] = nw;
                mt = fmaxf(mt, fmaxf(ts[p], tm[p]));
                mn = fmaxf(mn, nw);
            }
        }
        mt = warp_max(mt);
        mn = warp_max(mn);
        float* r = red + buf * 2 * NW;
        if (lane == 0) {
            r[warp] = mt;
            r[NW + warp] = mn;
        }
        tick(on, t0, acc[B_POS]);
        __syncthreads();
        float tmax = r[0], factor = r[NW];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
            tmax = fmaxf(tmax, r[w]);
            factor = fmaxf(factor, r[NW + w]);
        }
        tick(on, t0, acc[B_BAR1]);
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            ts[p] = ts[p] > 0.5f * NEG ? expf(ts[p] - tmax) : 0.f;
            tm[p] = tm[p] > 0.5f * NEG ? expf(tm[p] - tmax) : 0.f;
            part += ts[p] + tm[p];
        }
        part = warp_sum(part);
        if (lane == 0) sums[buf * NW + warp] = part;
        tick(on, t0, acc[B_EXP]);
        __syncthreads();
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) den += sums[buf * NW + w];
        den = den > 0.f ? den : 1.f;
        tick(on, t0, acc[B_BAR2]);
        const size_t out = (size_t)t * tstride + row;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = tid + p * NT;
            if (l < L) {
                post_stay[out + l] = ts[p] / den;
                post_move[out + l] = tm[p] / den;
            }
            st[p] = nst[p];
            mv[p] = nmv[p];
            fc[p] = nfc[p];
        }
        prev = factor;
        tick(on, t0, acc[B_STORE]);
        if (CLOCK) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                use(st[p]);
                use(mv[p]);
                use(fc[p]);
            }
        }
        tick(on, t0, acc[B_WAIT]);
    }
    if (on)
        for (int i = 0; i < B_NPH; ++i) cyc[blockIdx.x * B_NPH + i] = acc[i];
}

template <int NT, bool CLOCK>
__global__ void __launch_bounds__(NT)
crf_fwd_streams_gmem_kernel(const float* __restrict__ stay,
                            const float* __restrict__ move,
                            const int* __restrict__ valid,
                            float* __restrict__ fwd_final,
                            float* __restrict__ score_out,
                            float* __restrict__ lattice, float* gstate,
                            int T, int B, int L, long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32;
    __shared__ float red[2 * NW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    float* state = gstate + 2 * row;
    const bool on = CLOCK && tid == 0;
    long long t0 = 0, acc[F_NPH] = {};

    for (int l = tid; l < L; l += NT)
        state[l] = (l == 0 && valid[row + l] != 0) ? 0.f : NEG;
    __syncthreads();
    if (CLOCK) t0 = clock64();

    float prev = 0.f, score = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* cur = state + (t & 1) * L;
        float* nxt = state + ((t + 1) & 1) * L;
        const size_t off = (size_t)t * tstride + row;
        float m = NEG;
        for (int l = tid; l < L; l += NT) {
            const bool ok = valid[row + l] != 0;
            const float f = ok ? cur[l] - prev : NEG;
            if (lattice != nullptr) lattice[off + l] = f;
            float nw = NEG;
            if (ok) {
                const float mpart =
                    l > 0 ? (cur[l - 1] - prev) + move[off + l - 1] : NEG;
                nw = logaddexpf_(f + stay[off + l], mpart);
            }
            nxt[l] = nw;
            m = fmaxf(m, nw);
        }
        tick(on, t0, acc[F_POS]);
        prev = block_max<NT>(m, red + (t & 1) * NW, lane, warp);
        score += prev;
        tick(on, t0, acc[F_BAR]);
    }
    const float* fin = state + (T & 1) * L;
    for (int l = tid; l < L; l += NT)
        fwd_final[row + l] = valid[row + l] != 0 ? fin[l] - prev : NEG;
    if (tid == 0) score_out[blockIdx.x] = score;
    if (on)
        for (int i = 0; i < F_NPH; ++i) cyc[blockIdx.x * F_NPH + i] = acc[i];
}

template <int NT, bool CLOCK>
__global__ void __launch_bounds__(NT)
crf_bwd_posteriors_gmem_kernel(const float* __restrict__ stay,
                               const float* __restrict__ move,
                               const float* __restrict__ lattice,
                               const int* __restrict__ valid,
                               const int* __restrict__ lastpos,
                               float* __restrict__ post_stay,
                               float* __restrict__ post_move,
                               float* gstate, int T, int B, int L,
                               long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32;
    __shared__ float red[4 * NW];
    __shared__ float sums[2 * NW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    const int last = lastpos[blockIdx.x];
    float* state = gstate + 2 * row;
    const bool on = CLOCK && tid == 0;
    long long t0 = 0, acc[B_NPH] = {};

    for (int l = tid; l < L; l += NT)
        state[l] = (l == last && valid[row + l] != 0) ? 0.f : NEG;
    __syncthreads();
    if (CLOCK) t0 = clock64();

    float prev = 0.f;
    for (int s = 0; s < T; ++s) {
        const int t = T - 1 - s;
        const int buf = s & 1;
        const float* cur = state + buf * L;
        float* nxt = state + (buf ^ 1) * L;
        const size_t off = (size_t)t * tstride + row;
        float mt = NEG, mn = NEG;
        for (int l = tid; l < L; l += NT) {
            float nw = NEG;
            if (valid[row + l] != 0) {
                const float st = stay[off + l];
                const float fc = lattice[off + l];
                const float bn = cur[l] - prev;
                float tm = NEG, mpart = NEG;
                if (l < last) {
                    const float mv = move[off + l];
                    const float bs = cur[l + 1] - prev;
                    tm = fc + bs + mv;
                    mpart = mv + bs;
                }
                nw = logaddexpf_(st + bn, mpart);
                mt = fmaxf(mt, fmaxf(fc + bn + st, tm));
            }
            nxt[l] = nw;
            mn = fmaxf(mn, nw);
        }
        mt = warp_max(mt);
        mn = warp_max(mn);
        float* r = red + buf * 2 * NW;
        if (lane == 0) {
            r[warp] = mt;
            r[NW + warp] = mn;
        }
        tick(on, t0, acc[B_POS]);
        __syncthreads();
        float tmax = r[0], factor = r[NW];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
            tmax = fmaxf(tmax, r[w]);
            factor = fmaxf(factor, r[NW + w]);
        }
        tick(on, t0, acc[B_BAR1]);
        float part = 0.f;
        for (int l = tid; l < L; l += NT) {
            float ts = NEG, tm = NEG;
            if (valid[row + l] != 0) {
                const float fc = lattice[off + l];
                const float bn = cur[l] - prev;
                ts = fc + bn + stay[off + l];
                if (l < last) tm = fc + (cur[l + 1] - prev) + move[off + l];
            }
            ts = ts > 0.5f * NEG ? expf(ts - tmax) : 0.f;
            tm = tm > 0.5f * NEG ? expf(tm - tmax) : 0.f;
            post_stay[off + l] = ts;
            post_move[off + l] = tm;
            part += ts + tm;
        }
        part = warp_sum(part);
        if (lane == 0) sums[buf * NW + warp] = part;
        tick(on, t0, acc[B_EXP]);
        __syncthreads();
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) den += sums[buf * NW + w];
        den = den > 0.f ? den : 1.f;
        tick(on, t0, acc[B_BAR2]);
        for (int l = tid; l < L; l += NT) {
            post_stay[off + l] = post_stay[off + l] / den;
            post_move[off + l] = post_move[off + l] / den;
        }
        prev = factor;
        tick(on, t0, acc[B_STORE]);
    }
    if (on)
        for (int i = 0; i < B_NPH; ++i) cyc[blockIdx.x * B_NPH + i] = acc[i];
}

template <class K>
int smem_attr(K kernel, size_t smem)
{
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
}

template <int NT, int P, bool CLOCK>
int launch_fwd(const float* stay, const float* move, const int* valid,
               float* fwd_final, float* score, float* lattice, int T, int B,
               int L, long long* cyc, cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 2 * (NT / 32));
    int e = smem_attr(crf_fwd_streams_kernel<NT, P, CLOCK>, smem);
    if (e) return e;
    crf_fwd_streams_kernel<NT, P, CLOCK><<<B, NT, smem, st>>>(
        stay, move, valid, fwd_final, score, lattice, T, B, L, cyc);
    return static_cast<int>(cudaGetLastError());
}

template <int NT, int P, bool CLOCK>
int launch_bwd(const float* stay, const float* move, const float* lattice,
               const int* valid, const int* last, float* post_stay,
               float* post_move, int T, int B, int L, long long* cyc,
               cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 6 * (NT / 32));
    int e = smem_attr(crf_bwd_posteriors_kernel<NT, P, CLOCK>, smem);
    if (e) return e;
    crf_bwd_posteriors_kernel<NT, P, CLOCK><<<B, NT, smem, st>>>(
        stay, move, lattice, valid, last, post_stay, post_move, T, B, L,
        cyc);
    return static_cast<int>(cudaGetLastError());
}

#define V1_CASES(CALL)                                          \
    if (L <= 256) return CALL(256, 1);                          \
    if (L <= 512) return CALL(256, 2);                          \
    if (L <= 1024) return CALL(256, 4);                         \
    if (L <= 2048) return CALL(256, 8);                         \
    if (L <= 4096) return CALL(512, 8);                         \
    if (L <= 8192) return CALL(1024, 8);                        \
    if (L <= 16384) return CALL(1024, 16);                      \
    return static_cast<int>(cudaErrorInvalidValue);

template <bool CLOCK>
int fwd(const float* stay, const float* move, const int* valid,
        float* fwd_final, float* score, float* lattice, float* gstate, int T,
        int B, int L, long long* cyc, cudaStream_t st)
{
    if (L > MAX_L_SMEM) {
        crf_fwd_streams_gmem_kernel<GMEM_NT, CLOCK><<<B, GMEM_NT, 0, st>>>(
            stay, move, valid, fwd_final, score, lattice, gstate, T, B, L,
            cyc);
        return static_cast<int>(cudaGetLastError());
    }
#define F(NT, P) launch_fwd<NT, P, CLOCK>(stay, move, valid, fwd_final, \
                                          score, lattice, T, B, L, cyc, st)
    V1_CASES(F)
#undef F
}

template <bool CLOCK>
int bwd(const float* stay, const float* move, const float* lattice,
        const int* valid, const int* last, float* post_stay,
        float* post_move, float* gstate, int T, int B, int L,
        long long* cyc, cudaStream_t st)
{
    if (L > MAX_L_SMEM) {
        crf_bwd_posteriors_gmem_kernel<GMEM_NT, CLOCK>
            <<<B, GMEM_NT, 0, st>>>(stay, move, lattice, valid, last,
                                    post_stay, post_move, gstate, T, B, L,
                                    cyc);
        return static_cast<int>(cudaGetLastError());
    }
#define BW(NT, P) launch_bwd<NT, P, CLOCK>(stay, move, lattice, valid, last, \
                                           post_stay, post_move, T, B, L,    \
                                           cyc, st)
    V1_CASES(BW)
#undef BW
}

}  // namespace v1

extern "C" {

// the first design (v1) at L's layout; with clock, cyc [B][3]; gstate
// [B, 2, L] past 16384 positions
int probe_fwd_v1(const float* stay, const float* move, const int* valid,
                 float* fwd_final, float* score, float* lattice,
                 float* gstate, int T, int B, int L, int clock,
                 long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return clock ? v1::fwd<true>(stay, move, valid, fwd_final, score,
                                 lattice, gstate, T, B, L, cyc, st)
                 : v1::fwd<false>(stay, move, valid, fwd_final, score,
                                  lattice, gstate, T, B, L, cyc, st);
}

// the first design's posteriors; with clock, cyc [B][6]
int probe_bwd_v1(const float* stay, const float* move, const float* lattice,
                 const int* valid, const int* last, float* post_stay,
                 float* post_move, float* gstate, int T, int B, int L,
                 int clock, long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return clock ? v1::bwd<true>(stay, move, lattice, valid, last, post_stay,
                                 post_move, gstate, T, B, L, cyc, st)
                 : v1::bwd<false>(stay, move, lattice, valid, last,
                                  post_stay, post_move, gstate, T, B, L, cyc,
                                  st);
}

// the redesign's chain (bwd: kernel 10's, writing the backward lattice
// into `lattice`) in layout (NT, P, CL) at ring depth K (0: its rule),
// refused (cudaErrorInvalidValue) for a layout not instantiated here or
// narrower than L; NT = 0: csrc/crf.cu's band for L, with its phase clock
// into cyc [B][FWD_PHASES] where cyc is not null
int probe_chain(const float* stay, const float* move, const int* valid,
                const int* last, float* fwd_final, float* score,
                float* lattice, float* gstate, int T, int B, int L, int bwd,
                int NT, int P, int CL, int K, long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS stay, move, valid, last, fwd_final, score, lattice
    if (NT == 0) {
        if (bwd)
            return cyc ? stream_chain<true, true>(ARGS, gstate, T, B, L, K,
                                                  cyc, st)
                       : stream_chain<true, false>(ARGS, gstate, T, B, L, K,
                                                   nullptr, st);
        return cyc ? stream_chain<false, true>(ARGS, gstate, T, B, L, K, cyc,
                                               st)
                   : stream_chain<false, false>(ARGS, gstate, T, B, L, K,
                                                nullptr, st);
    }
#define V(nt, p, cl)                                                       \
    if (NT == nt && P == p && CL == cl) {                                  \
        if (L > nt * p * cl) return static_cast<int>(cudaErrorInvalidValue); \
        return bwd ? stream_chain_at<nt, p, cl, true, false>(                \
                         ARGS, T, B, L, K, nullptr, st)                      \
                   : stream_chain_at<nt, p, cl, false, false>(               \
                         ARGS, T, B, L, K, nullptr, st);                     \
    }
    V(512, 2, 1) V(1024, 1, 1) V(1024, 2, 1) V(1024, 4, 1) V(1024, 2, 2)
    V(1024, 4, 2) V(1024, 4, 4) V(1024, 2, 8) V(1024, 4, 8) V(1024, 8, 4)
#undef V
#undef ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// the ints of the column lists of B rows; the floats of the pass's
// exponentials in device memory (0 where they fit shared memory)
long long probe_list_ints(int B, int L, int S)
{
    return (long long)B * list_ints(L, S);
}

long long probe_post_gex(int L, int S, int grad)
{
    return post_in_smem(L, S, grad != 0) ? 0 : 2LL * card_sms() * L;
}

int probe_lists(const int* sidx, const int* midx, const int* mmidx,
                const float* mfact, const int* valid, const int* last,
                int* lists, int B, int L, int S, void* stream)
{
    return launch_lists(sidx, midx, mmidx, mfact, valid, last, lists, B, L,
                        S, static_cast<cudaStream_t>(stream));
}

// the posterior pass alone (grad: into d lp out0 [T, B, S] through the
// lists; else the posteriors out0, out1); with cyc, its phase clock
// [grid][3] (terms, exponentials, epilogue) of each CTA's thread 0
int probe_post(const float* stay, const float* move, const float* lattice,
               const float* blat, const int* valid, const int* last,
               const float* mfact, const int* lists, float* out0,
               float* out1, float* gex, int T, int B, int L, int S, int grad,
               long long* cyc, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS stay, move, lattice, blat, valid, last, mfact, lists, out0, \
        out1, gex, T, B, L, S
    if (grad)
        return cyc ? post_dispatch<true, true>(ARGS, cyc, st)
                   : post_dispatch<true, false>(ARGS, nullptr, st);
    return cyc ? post_dispatch<false, true>(ARGS, cyc, st)
               : post_dispatch<false, false>(ARGS, nullptr, st);
#undef ARGS
}

// row 6 (the fused backward, posteriors off the chain in the chain's own
// block) on the same shape, for the in-block design's time
int probe_row6(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const float* lattice,
               const int* valid, const int* last, float* grad, int T, int B,
               int S, int L, void* stream)
{
    return crf_bwd_dispatch<false>(lp, sidx, midx, mmidx, mfact, lattice,
                                   valid, last, grad, T, B, S, L, 0, nullptr,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
