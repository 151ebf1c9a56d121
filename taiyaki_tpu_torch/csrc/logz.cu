// Flip-flop partition function for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernels taiyaki_tpu/ops/pallas_logz.py:142
// `logz_forward` (tt_logz_fwd) and pallas_logz.py:249
// `logz_backward_posteriors` (tt_logz_posteriors).
//
// The flip-flop lattice has NFF = 2*NB states (flip bases 0..NB-1, flop
// bases NB..NFF-1) and S = NFF*(NB+1) transitions per step.  Transition
// column j = row*NFF + src: rows 0..NB-1 move into flip base `row` from
// any source; row NB moves flip src -> flop src (src < NB) or stays in
// flop src (src >= NB).
//
// Forward: per step the state vector fwd (renormalised to logsumexp 0)
// advances as new[d] = logsumexp_{j into d} (fwd[src(j)] + scores[t, j]);
// logZ accumulates the renormalisers.  The result leaves out the initial
// log(NB) term, as the TPU kernel does (flipflop_logz adds it).  With a
// lattice pointer, fwd before each step is stored ([T, B, NFF]).
//
// Posteriors: a reverse pass of the backward vector (renormalised by its
// max) and, per step, the softmax over the S transitions of
// fwd[src] + scores + bwd_next[dst] = d logZ / d scores.  A row with no
// path (every term -inf) gives zeros, and its vectors stay -inf instead
// of turning into NaN.
//
// Forward layout: G lanes of one warp per batch row (G = NFF rounded up to
// a power of two: 8 for NB = 4), lane = one lattice state, gathering the
// states it needs with warp shuffles and reducing its own incoming
// transitions; row-wide reductions are butterfly shuffles within the G
// lanes; each step's scores are loaded one step ahead into registers.
// What bounds it is the serial chain of T dependent steps (shuffles, exp,
// log), not bytes: the main path's scores are 20 MB, a few microseconds of
// device memory time, while each step costs some hundreds of cycles of
// latency, and B = 128 rows make only 16 blocks of 64 threads.
//
// The posteriors (tt_logz_posteriors) had the same layout and bound (a
// chain of T steps of 14 levels of shuffles, 10 exp, a log and 5 divides,
// 32 of 132 SMs busy at most); they now cut T into segments so that the
// card fills and the chain is ~2K + T/K steps deep (below).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 64;

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

// logsumexp of N values; -inf when all are -inf
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

template <int NB>
__global__ void __launch_bounds__(THREADS)
logz_fwd_kernel(const float* __restrict__ scores, float* __restrict__ fwd_final,
                float* __restrict__ logz_out, float* __restrict__ lattice,
                int T, int B)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    const int lane = threadIdx.x & 31;
    const int d = lane & (G - 1);
    const int gbase = lane - d;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool valid = b < B && d < NFF;
    const bool flip = d < NB;
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
        float cand[NFF];
#pragma unroll
        for (int q = 0; q < NFF; ++q) {
            const float fs = flip ? f[q]
                : (q == 0 ? from_flip : (q == 1 ? fwd : -INFINITY));
            cand[q] = fs + sc[q];
        }
        const float nw = valid ? lse<NFF>(cand) : -INFINITY;
        const float m = group_max<G>(nw);
        const float sum = group_sum<G>(m == -INFINITY ? 0.f : expf(nw - m));
        const float factor = m == -INFINITY ? -INFINITY : m + logf(sum);
        fwd = factor == -INFINITY ? -INFINITY : nw - factor;
        logz += factor;
#pragma unroll
        for (int q = 0; q < NFF; ++q) sc[q] = nx[q];
    }
    if (valid) {
        fwd_final[(size_t)b * NFF + d] = fwd;
        if (d == 0) logz_out[b] = logz;
    }
}

// ---- the posteriors: T cut into segments of K steps ----------------------
//
// The backward vector obeys bwd_t = A_t (x) bwd_{t+1} in the (logsumexp, +)
// semiring, A_t[s][d] the scores of the transitions s -> d at step t, and
// the posteriors of step t need only bwd_{t+1}, so T is cut into segments
// of K steps:
//   A  logz_transfer_kernel: in parallel over (row, segment g >= 1), the
//      segment's transfer A_{gK} (x) ... (x) A_{gK+K-1}, NFF x NFF, each
//      column d run by one lane as the backward recursion from the unit
//      vector e_d, all NFF columns renormalised together by their joint
//      max each step (values stay near 0, so their rounding stays at the
//      recursion's own; the common factor does not matter);
//   B  logz_boundary_kernel: per row, the serial pass over the segments
//      from the last (which starts from the uniform vector, as the
//      recursion does) to the first: bwd at each segment's end, one
//      transfer product a segment, renormalised by its max;
//   C  logz_post_kernel: in parallel over (row, segment), the segment's K
//      steps rerun from its true end vector in the arithmetic of the plain
//      twin's recursion, each step's posteriors written.
// The serial depth falls from T steps to about 2K + T/K, and B x T/K
// threads share the chain work instead of B x NFF lanes.
//
// Scratch, without an allocation: the transfer of segment g (g >= 1) and
// the end vector of segment g - 1 live in the output rows of segment
// g - 1 of their row (K steps x S floats, of which NFF^2 + NFF are used),
// which kernel C of that (row, segment) overwrites only after it has read
// its end vector there.
//
// In C one thread holds the whole NFF-vector in registers, so a step is
// register arithmetic (no shuffles); the next step's score and lattice
// rows are loaded a step ahead (16- and 8-byte loads: S is a multiple of
// 4, NFF of 2).  A step's posteriors come from the terms it computes for
// the recursion: with o_j = scores_j + bwd[dst_j] and, for each source s,
// m_s = max o_j over its NB + 1 transitions and e_j = exp(o_j - m_s),
// new[s] = m_s + log(sum e_j) and post_j = e_j exp(lattice[s] + m_s - M)
// / sum_s exp(lattice[s] + new[s] - M), M = max_s(lattice[s] + new[s]):
// one reciprocal a step, S + 2 NFF exponentials besides the recursion's
// S.  With NB > 4 the rows are not held in registers (144 scores at NB =
// 8) and e_j is computed again for the posteriors.
//
// Log space throughout: the contract takes any f32 scores, -inf included,
// and a linear-space transfer would flush paths more than ~87 nats below
// a step's best to zero.

constexpr int SEG_THREADS = 128;
constexpr int POST_THREADS = 64;
constexpr int MIN_SEGMENT = 16, MAX_SEGMENT = 32;
constexpr long long POST_ROWS_STEPS = 8192;

// index in the output of element i of the scratch of (row b, segment
// starting at t0)
template <int S>
__device__ __forceinline__ size_t scratch_at(int i, int t0, int B, int b)
{
    return ((size_t)(t0 + i / S) * B + b) * S + i % S;
}

// the destination state of transition column j = q * NFF + s
template <int NB>
__device__ __forceinline__ constexpr int dst_of(int q, int s)
{
    return q < NB ? q : NB + s % NB;
}

template <int N>
__device__ __forceinline__ void load_row(float* out, const float* row)
{
    if constexpr (N % 4 == 0) {
        const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
        for (int k = 0; k < N / 4; ++k) {
            const float4 x = r[k];
            out[4 * k] = x.x;
            out[4 * k + 1] = x.y;
            out[4 * k + 2] = x.z;
            out[4 * k + 3] = x.w;
        }
    } else {
        const float2* r = reinterpret_cast<const float2*>(row);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) {
            const float2 x = r[k];
            out[2 * k] = x.x;
            out[2 * k + 1] = x.y;
        }
    }
}

template <int NB>
__global__ void __launch_bounds__(SEG_THREADS)
logz_transfer_kernel(const float* __restrict__ scores,
                     float* __restrict__ post, int T, int B, int K, int nseg)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    constexpr bool REG = NB <= 4;
    const size_t grp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int d = threadIdx.x & (G - 1);
    const bool live = grp < (size_t)B * (nseg - 1);
    const int b = live ? (int)(grp % B) : 0;
    const int t0 = live ? (1 + (int)(grp / B)) * K : K;
    const size_t rowstride = (size_t)B * S;
    const float* srow = scores + (size_t)b * S;

    float c[NFF];
#pragma unroll
    for (int s = 0; s < NFF; ++s) c[s] = s == d ? 0.f : -INFINITY;
    float cur[REG ? S : 1], nxt[REG ? S : 1];
    // every lane runs K steps (its group max is a shuffle); the steps a
    // short last segment lacks leave the column as it is
    int t = min(T, t0 + K) - 1;
    if constexpr (REG) {
        if (live) load_row<S>(cur, srow + t * rowstride);
    }
    for (int k = 0; k < K; ++k, --t) {
        const bool step = live && t >= t0;
        if constexpr (REG) {
            if (step && t > t0) load_row<S>(nxt, srow + (t - 1) * rowstride);
        }
        const float* row = srow + (size_t)(step ? t : 0) * rowstride;
        float nw[NFF], m = -INFINITY;
#pragma unroll
        for (int s = 0; s < NFF; ++s) {
            float o[NB + 1];
#pragma unroll
            for (int q = 0; q <= NB; ++q) {
                const int j = q * NFF + s;
                o[q] = (REG ? cur[REG ? j : 0] : __ldg(row + j))
                    + c[dst_of<NB>(q, s)];
            }
            nw[s] = step ? lse<NB + 1>(o) : c[s];
            m = fmaxf(m, nw[s]);
        }
        m = group_max<G>(m);
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            c[s] = m == -INFINITY ? -INFINITY : nw[s] - m;
        if constexpr (REG) {
            if (step && t > t0) {
#pragma unroll
                for (int j = 0; j < S; ++j) cur[j] = nxt[j];
            }
        }
    }
    if (live && d < NFF) {
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            post[scratch_at<S>(s * NFF + d, t0 - K, B, b)] = c[s];
    }
}

template <int NB>
__global__ void __launch_bounds__(SEG_THREADS)
logz_boundary_kernel(float* __restrict__ post, int T, int B, int K, int nseg)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    const int s = threadIdx.x & (G - 1);
    const int gbase = (threadIdx.x & 31) - s;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool live = b < B && s < NFF;

    // the end vector of the last segment: the recursion's start
    float v[NFF], p[NFF], np[NFF];
#pragma unroll
    for (int d = 0; d < NFF; ++d) {
        v[d] = -logf((float)NFF);
        p[d] = live ? post[scratch_at<S>(s * NFF + d, (nseg - 2) * K, B, b)]
                    : -INFINITY;
    }
    for (int g = nseg - 1; g >= 1; --g) {
#pragma unroll
        for (int d = 0; d < NFF; ++d) {
            np[d] = live && g > 1
                ? post[scratch_at<S>(s * NFF + d, (g - 2) * K, B, b)]
                : -INFINITY;
        }
        float o[NFF];
#pragma unroll
        for (int d = 0; d < NFF; ++d) o[d] = p[d] + v[d];
        const float w = live ? lse<NFF>(o) : -INFINITY;
        float m = -INFINITY;
#pragma unroll
        for (int d = 0; d < NFF; ++d) {
            v[d] = __shfl_sync(FULL, w, gbase + d);
            m = fmaxf(m, v[d]);
        }
#pragma unroll
        for (int d = 0; d < NFF; ++d)
            v[d] = m == -INFINITY ? -INFINITY : v[d] - m;
        if (live) post[scratch_at<S>(NFF * NFF + s, (g - 1) * K, B, b)] = v[s];
#pragma unroll
        for (int d = 0; d < NFF; ++d) p[d] = np[d];
    }
}

template <int NB>
__global__ void __launch_bounds__(POST_THREADS)
logz_post_kernel(const float* __restrict__ scores,
                 const float* __restrict__ lattice, float* __restrict__ post,
                 int T, int B, int K, int nseg)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1);
    constexpr bool REG = NB <= 4;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B * nseg) return;
    const int b = (int)(i % B), g = (int)(i / B);
    const int t0 = g * K, t1 = min(T, t0 + K);
    const size_t rowstride = (size_t)B * S, lstride = (size_t)B * NFF;
    const float* srow = scores + (size_t)b * S;
    const float* lrow = lattice + (size_t)b * NFF;

    float v[NFF];
#pragma unroll
    for (int s = 0; s < NFF; ++s)
        v[s] = g == nseg - 1 ? -logf((float)NFF)
                             : post[scratch_at<S>(NFF * NFF + s, t0, B, b)];
    float cur[REG ? S : 1], nxt[REG ? S : 1], fw[NFF], nfw[NFF];
    if constexpr (REG) load_row<S>(cur, srow + (t1 - 1) * rowstride);
    load_row<NFF>(fw, lrow + (t1 - 1) * lstride);
    for (int t = t1 - 1; t >= t0; --t) {
        if (t > t0) {
            if constexpr (REG) load_row<S>(nxt, srow + (t - 1) * rowstride);
            load_row<NFF>(nfw, lrow + (t - 1) * lstride);
        }
        const float* row = srow + t * rowstride;
        // the recursion's terms, grouped by source state
        float e[REG ? S : 1], m[NFF], nw[NFF];
#pragma unroll
        for (int s = 0; s < NFF; ++s) {
            float o[NB + 1], mx = -INFINITY;
#pragma unroll
            for (int q = 0; q <= NB; ++q) {
                const int j = q * NFF + s;
                o[q] = (REG ? cur[REG ? j : 0] : __ldg(row + j))
                    + v[dst_of<NB>(q, s)];
                mx = fmaxf(mx, o[q]);
            }
            const float shift = mx == -INFINITY ? 0.f : mx;
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q <= NB; ++q) {
                const float ex = expf(o[q] - shift);
                if constexpr (REG) e[q * NFF + s] = ex;
                sum += ex;
            }
            m[s] = mx;
            nw[s] = mx == -INFINITY ? -INFINITY : mx + logf(sum);
        }
        // the posteriors: a row with no path at this step gets zeros
        float big = -INFINITY;
#pragma unroll
        for (int s = 0; s < NFF; ++s) big = fmaxf(big, fw[s] + nw[s]);
        float r[NFF];
        if (big == -INFINITY) {
#pragma unroll
            for (int s = 0; s < NFF; ++s) r[s] = 0.f;
        } else {
            float den = 0.f;
#pragma unroll
            for (int s = 0; s < NFF; ++s) den += expf(fw[s] + nw[s] - big);
            const float inv = 1.f / den;
#pragma unroll
            for (int s = 0; s < NFF; ++s)
                r[s] = expf(fw[s] + m[s] - big) * inv;
        }
        float4* prow = reinterpret_cast<float4*>(post + ((size_t)t * B + b) * S);
#pragma unroll
        for (int k = 0; k < S / 4; ++k) {
            float x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = 4 * k + u, s = j % NFF, q = j / NFF;
                float ex;
                if constexpr (REG) {
                    ex = e[j];
                } else {
                    const float shift = m[s] == -INFINITY ? 0.f : m[s];
                    ex = expf(__ldg(row + j) + v[dst_of<NB>(q, s)] - shift);
                }
                x[u] = ex * r[s];
            }
            prow[k] = make_float4(x[0], x[1], x[2], x[3]);
        }
        // the recursion: renormalised by its max
        float f = -INFINITY;
#pragma unroll
        for (int s = 0; s < NFF; ++s) f = fmaxf(f, nw[s]);
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            v[s] = f == -INFINITY ? -INFINITY : nw[s] - f;
        if (t > t0) {
            if constexpr (REG) {
#pragma unroll
                for (int j = 0; j < S; ++j) cur[j] = nxt[j];
            }
#pragma unroll
            for (int s = 0; s < NFF; ++s) fw[s] = nfw[s];
        }
    }
}

template <int NB>
int launch_fwd(const float* scores, float* fwd_final, float* logz,
               float* lattice, int T, int B, cudaStream_t st)
{
    constexpr int G = Group<2 * NB>::G;
    const int blocks = (int)(((size_t)B * G + THREADS - 1) / THREADS);
    logz_fwd_kernel<NB><<<blocks, THREADS, 0, st>>>(scores, fwd_final, logz,
                                                    lattice, T, B);
    return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_post(const float* scores, const float* lattice, float* post,
                int T, int B, int K, cudaStream_t st)
{
    constexpr int G = Group<2 * NB>::G;
    const int nseg = (T + K - 1) / K;
    if (nseg > 1) {
        const size_t lanes = (size_t)B * (nseg - 1) * G;
        logz_transfer_kernel<NB>
            <<<(unsigned)((lanes + SEG_THREADS - 1) / SEG_THREADS),
               SEG_THREADS, 0, st>>>(scores, post, T, B, K, nseg);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        logz_boundary_kernel<NB>
            <<<(unsigned)(((size_t)B * G + SEG_THREADS - 1) / SEG_THREADS),
               SEG_THREADS, 0, st>>>(post, T, B, K, nseg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const size_t threads = (size_t)B * nseg;
    logz_post_kernel<NB>
        <<<(unsigned)((threads + POST_THREADS - 1) / POST_THREADS),
           POST_THREADS, 0, st>>>(scores, lattice, post, T, B, K, nseg);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TT_NBASE_CASES(CALL) \
    switch (nbase) {         \
    case 1: return CALL(1);  \
    case 2: return CALL(2);  \
    case 3: return CALL(3);  \
    case 4: return CALL(4);  \
    case 5: return CALL(5);  \
    case 6: return CALL(6);  \
    case 7: return CALL(7);  \
    case 8: return CALL(8);  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
    }

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// scores [T, B, S] -> fwd_final [B, NFF], logz [B] (without log(nbase)),
// lattice [T, B, NFF] (may be null).  Returns cudaGetLastError().
int tt_logz_fwd(const float* scores, float* fwd_final, float* logz,
                float* lattice, int T, int B, int nbase, void* stream)
{
    if (B == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_FWD(NB) launch_fwd<NB>(scores, fwd_final, logz, lattice, T, B, st)
    TT_NBASE_CASES(TT_FWD)
#undef TT_FWD
}

// the segment length K of a call: about T B / POST_ROWS_STEPS steps,
// within MIN_SEGMENT .. MAX_SEGMENT, so that the rerun (kernel C) runs
// some 8000 (row, segment) threads (probes/posteriors.py times K = 8 ...
// 64 on the card: 16 best at T=1000, B=128, 24 at T=800, B=256); one
// segment when T is that short
int tt_logz_post_segment(int T, int B, int nbase)
{
    (void)nbase;
    long long k = ((long long)T * B + POST_ROWS_STEPS / 2) / POST_ROWS_STEPS;
    k = k < MIN_SEGMENT ? MIN_SEGMENT : k > MAX_SEGMENT ? MAX_SEGMENT : k;
    return T <= k ? (T > 2 ? T : 2) : (int)k;
}

// the kernels a call launches: the transfers, the boundaries and the
// posteriors, or the posteriors alone when T is one segment
int tt_logz_post_kernels(int T, int B, int nbase)
{
    return T > tt_logz_post_segment(T, B, nbase) ? 3 : 1;
}

}  // extern "C"

// scores [T, B, S], lattice [T, B, NFF] -> post [T, B, S], with segments of
// K steps (K <= 0: tt_logz_post_segment's; at least 2, so that a
// segment's rows hold the scratch of the next).  scores 16-byte and
// lattice 8-byte aligned.
int logz_post_launch(const float* scores, const float* lattice, float* post,
                     int T, int B, int nbase, int K, cudaStream_t st)
{
    if (B == 0 || T == 0) return 0;
    if (K <= 0) K = tt_logz_post_segment(T, B, nbase);
    if (K < 2) K = 2;
#define TT_POST(NB) launch_post<NB>(scores, lattice, post, T, B, K, st)
    TT_NBASE_CASES(TT_POST)
#undef TT_POST
}

extern "C" {

// scores [T, B, S], lattice [T, B, NFF] -> post [T, B, S].
int tt_logz_posteriors(const float* scores, const float* lattice, float* post,
                       int T, int B, int nbase, void* stream)
{
    return logz_post_launch(scores, lattice, post, T, B, nbase, 0,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
