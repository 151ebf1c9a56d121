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
// path (every term -inf) gives zeros and logZ -inf, and its vectors stay
// -inf instead of turning into NaN.
//
// Both recursions are products in the (logsumexp, +) semiring: fwd_{t+1}
// = fwd_t (x) A_t and bwd_t = A_t (x) bwd_{t+1}, A_t[s][d] the scores of
// the transitions s -> d at step t.  What bounds a row's pass is its
// serial chain of T dependent steps (exp, log, a max), not bytes: the
// main path's scores are 20 MB, a few microseconds of device memory time.
// Run as one chain a row (the first designs: G lanes a row, a shuffle for
// every state it reads), B = 128 rows filled 16 blocks of 64 threads and
// a step cost some 1100 cycles (0.63 ms at T=1000).  So both passes cut T
// into segments of K steps: the segments' transfers in parallel, a serial
// pass over the segments, then every segment rerun in parallel from its
// start vector (forward) or end vector (posteriors): a chain ~2K + T/K
// steps deep, on B T / K threads instead of B chains.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

constexpr int SEG_THREADS = 128;
constexpr int POST_THREADS = 64;
constexpr int MIN_SEGMENT = 16, MAX_SEGMENT = 32;
constexpr long long POST_ROWS_STEPS = 8192;

// the destination state of transition column j = q * NFF + s
template <int NB>
__device__ __forceinline__ constexpr int dst_of(int q, int s)
{
    return q < NB ? q : NB + s % NB;
}

inline bool aligned16(const void* p)
{
    return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// N floats of a row into registers: 16-byte loads where N % 4 == 0, else
// 8-byte (N is even), both needing the row aligned to them; with VEC
// false 4-byte loads, which any contiguous f32 view allows
template <int N, bool VEC = true>
__device__ __forceinline__ void load_row(float* out, const float* row)
{
    if constexpr (!VEC) {
#pragma unroll
        for (int k = 0; k < N; ++k) out[k] = row[k];
    } else if constexpr (N % 4 == 0) {
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

// N floats from registers into an aligned row of this file's outputs or
// scratch (16-byte stores where N % 4 == 0, else 8-byte)
template <int N>
__device__ __forceinline__ void store_row(float* row, const float* v)
{
    if constexpr (N % 4 == 0) {
        float4* r = reinterpret_cast<float4*>(row);
#pragma unroll
        for (int k = 0; k < N / 4; ++k)
            r[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                               v[4 * k + 3]);
    } else {
        float2* r = reinterpret_cast<float2*>(row);
#pragma unroll
        for (int k = 0; k < N / 2; ++k)
            r[k] = make_float2(v[2 * k], v[2 * k + 1]);
    }
}

// ---- the forward: T cut into segments of K steps -------------------------
//
//   A  logz_fwd_transfer_kernel: in parallel over (row, segment g < nseg -
//      1), the segment's transfer M_g = A_{gK} (x) ... (x) A_{gK+K-1},
//      NFF x NFF, each row s run by one lane as the forward recursion from
//      the unit vector e_s, all NFF rows renormalised together by their
//      joint max each step (the common factor does not matter: B
//      renormalises);
//   B  logz_fwd_boundary_kernel: per row, the serial pass over the
//      segments: v_0 the recursion's start, v_{g+1} = v_g (x) M_g
//      renormalised to logsumexp 0, as the recursion holds its vector;
//      one transfer product a segment.  It also clears the row's count;
//   C  logz_fwd_rerun_kernel: in parallel over (row, segment), the
//      segment's steps rerun from v_g by one thread holding the vector in
//      registers, in the arithmetic of the plain twin's recursion: each
//      step's lattice row stored (fwd before the step), its factor (the
//      logsumexp of the new vector) added to the segment's sum.  The last
//      segment's thread writes fwd_final.  Each thread then stores its
//      sum and counts itself done (an integer atomic); the row's last one
//      adds the row's sums in segment order into logZ.  No float atomics:
//      logZ is bitwise the same with or without the lattice, and from run
//      to run.
// One launch (C alone) when T is one segment.  The scratch (transfers,
// start vectors, segment sums, counts: FwdScratch) is a tensor the wrapper
// allocates.  Each score row is loaded a step ahead into registers (NB <=
// 4), 16 bytes at a time where the scores are 16-byte aligned, else 4, so
// that any contiguous view runs.
//
// Cost: A runs B (T - K) / K groups of NFF lanes for K steps (the forward
// recursion's arithmetic NFF times over, its exponentials bound it), B a
// chain of T / K transfer products a row, C the recursion once more on
// B T / K threads.

constexpr long long FWD_ROWS_STEPS = 8192;

// float offsets of the forward's scratch: transfers [nseg - 1][B][NFF]
// [NFF], start vectors of segments 1.. [nseg - 1][B][NFF], segment sums
// [nseg][B], counts [B] (int); none for one segment
struct FwdScratch {
    size_t trans, starts, sums, cnt, floats;
    __host__ __device__ FwdScratch(int B, int nff, int nseg)
    {
        trans = 0;
        starts = trans + (size_t)(nseg - 1) * B * nff * nff;
        sums = starts + (size_t)(nseg - 1) * B * nff;
        cnt = sums + (size_t)nseg * B;
        floats = nseg > 1 ? cnt + B : 0;
    }
};

// one step of the forward recursion from v: nw[d] the logsumexp over the
// transitions into d of v[src] + score, a flip base from every source, a
// flop base from its flip base and itself, as the plain twin forms them;
// sc(j) the score of column j
template <int NB, typename Score>
__device__ __forceinline__ void fwd_step(float (&nw)[2 * NB],
                                         const float (&v)[2 * NB], Score sc)
{
    constexpr int NFF = 2 * NB;
#pragma unroll
    for (int d = 0; d < NB; ++d) {
        float o[NFF];
#pragma unroll
        for (int s = 0; s < NFF; ++s) o[s] = v[s] + sc(d * NFF + s);
        nw[d] = lse<NFF>(o);
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
        const float o[2] = {v[e] + sc(NB * NFF + e),
                            v[NB + e] + sc(NB * NFF + NB + e)};
        nw[NB + e] = lse<2>(o);
    }
}

template <int NB, bool VEC>
__global__ void __launch_bounds__(SEG_THREADS)
logz_fwd_transfer_kernel(const float* __restrict__ scores,
                         float* __restrict__ scratch, int B, int K,
                         int nseg)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1), G = Group<NFF>::G;
    constexpr bool REG = NB <= 4;
    const size_t grp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int s = threadIdx.x & (G - 1);
    // a group is live or not as a whole (its lanes share the group max)
    const bool live = grp < (size_t)B * (nseg - 1);
    const int b = live ? (int)(grp % B) : 0;
    const int t0 = live ? (int)(grp / B) * K : 0;
    const size_t rowstride = (size_t)B * S;
    const float* srow = scores + (size_t)b * S;

    float c[NFF];
#pragma unroll
    for (int d = 0; d < NFF; ++d) c[d] = d == s ? 0.f : -INFINITY;
    float cur[REG ? S : 1], nxt[REG ? S : 1];
    if constexpr (REG) {
        if (live) load_row<S, VEC>(cur, srow + t0 * rowstride);
    }
    // every segment but the last has all K steps
    for (int k = 0; k < K; ++k) {
        const int t = t0 + k;
        if constexpr (REG) {
            if (live && k + 1 < K)
                load_row<S, VEC>(nxt, srow + (t + 1) * rowstride);
        }
        const float* row = srow + (size_t)t * rowstride;
        float nw[NFF], m = -INFINITY;
        fwd_step<NB>(nw, c, [&](int j) {
            return REG ? cur[REG ? j : 0] : __ldg(row + j);
        });
#pragma unroll
        for (int d = 0; d < NFF; ++d) m = fmaxf(m, nw[d]);
        m = group_max<G>(m);
#pragma unroll
        for (int d = 0; d < NFF; ++d)
            c[d] = m == -INFINITY ? -INFINITY : nw[d] - m;
        if constexpr (REG) {
            if (k + 1 < K) {
#pragma unroll
                for (int j = 0; j < S; ++j) cur[j] = nxt[j];
            }
        }
    }
    if (live && s < NFF)
        store_row<NFF>(scratch + ((grp * NFF) + s) * NFF, c);
}

template <int NB>
__global__ void __launch_bounds__(SEG_THREADS)
logz_fwd_boundary_kernel(float* __restrict__ scratch, int B, int nseg)
{
    constexpr int NFF = 2 * NB, G = Group<NFF>::G;
    const FwdScratch at(B, NFF, nseg);
    const int d = threadIdx.x & (G - 1);
    const int gbase = (threadIdx.x & 31) - d;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool live = b < B && d < NFF;
    const float* trans = scratch + at.trans;
    // lane d reads column d of a transfer: M_g[s][d], s = 0 .. NFF - 1
    auto column = [&](float (&p)[NFF], int g) {
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            p[s] = live ? trans[(((size_t)g * B + b) * NFF + s) * NFF + d]
                        : -INFINITY;
    };

    float v[NFF], p[NFF], np[NFF];
#pragma unroll
    for (int s = 0; s < NFF; ++s) v[s] = s < NB ? -logf((float)NB) : -INFINITY;
    column(p, 0);
    for (int g = 0; g + 1 < nseg; ++g) {
        if (g + 2 < nseg) column(np, g + 1);
        float o[NFF];
#pragma unroll
        for (int s = 0; s < NFF; ++s) o[s] = v[s] + p[s];
        const float w = live ? lse<NFF>(o) : -INFINITY;
#pragma unroll
        for (int s = 0; s < NFF; ++s) v[s] = __shfl_sync(FULL, w, gbase + s);
        const float f = lse<NFF>(v);
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            v[s] = f == -INFINITY ? -INFINITY : v[s] - f;
        if (live)
            scratch[at.starts + ((size_t)g * B + b) * NFF + d] =
                f == -INFINITY ? -INFINITY : w - f;
#pragma unroll
        for (int s = 0; s < NFF; ++s) p[s] = np[s];
    }
    if (b < B && d == 0) reinterpret_cast<int*>(scratch + at.cnt)[b] = 0;
}

template <int NB, bool VEC>
__global__ void __launch_bounds__(POST_THREADS)
logz_fwd_rerun_kernel(const float* __restrict__ scores,
                      float* __restrict__ fwd_final,
                      float* __restrict__ logz_out,
                      float* __restrict__ lattice,
                      float* __restrict__ scratch, int T, int B, int K,
                      int nseg)
{
    constexpr int NFF = 2 * NB, S = NFF * (NB + 1);
    constexpr bool REG = NB <= 4;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B * nseg) return;
    const int b = (int)(i % B), g = (int)(i / B);
    const int t0 = g * K, t1 = min(T, t0 + K);
    const FwdScratch at(B, NFF, nseg);
    const size_t rowstride = (size_t)B * S;
    const float* srow = scores + (size_t)b * S;

    float v[NFF];
    if (g == 0) {
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            v[s] = s < NB ? -logf((float)NB) : -INFINITY;
    } else {
        load_row<NFF>(v, scratch + at.starts + ((size_t)(g - 1) * B + b)
                                                   * NFF);
    }
    float cur[REG ? S : 1], nxt[REG ? S : 1];
    if constexpr (REG) {
        if (t0 < t1) load_row<S, VEC>(cur, srow + (size_t)t0 * rowstride);
    }
    float sum = 0.f;
    for (int t = t0; t < t1; ++t) {
        if constexpr (REG) {
            if (t + 1 < t1)
                load_row<S, VEC>(nxt, srow + (size_t)(t + 1) * rowstride);
        }
        if (lattice != nullptr)
            store_row<NFF>(lattice + ((size_t)t * B + b) * NFF, v);
        const float* row = srow + (size_t)t * rowstride;
        float nw[NFF];
        fwd_step<NB>(nw, v, [&](int j) {
            return REG ? cur[REG ? j : 0] : __ldg(row + j);
        });
        const float f = lse<NFF>(nw);
#pragma unroll
        for (int s = 0; s < NFF; ++s)
            v[s] = f == -INFINITY ? -INFINITY : nw[s] - f;
        sum += f;
        if constexpr (REG) {
            if (t + 1 < t1) {
#pragma unroll
                for (int j = 0; j < S; ++j) cur[j] = nxt[j];
            }
        }
    }
    if (g == nseg - 1) store_row<NFF>(fwd_final + (size_t)b * NFF, v);
    if (nseg == 1) {
        logz_out[b] = sum;
        return;
    }
    float* sums = scratch + at.sums;
    sums[(size_t)g * B + b] = sum;
    __threadfence();
    int* cnt = reinterpret_cast<int*>(scratch + at.cnt);
    if (atomicAdd(cnt + b, 1) == nseg - 1) {
        // every segment of the row has stored its sum
        __threadfence();
        float z = 0.f;
        for (int q = 0; q < nseg; ++q) z += __ldcg(sums + (size_t)q * B + b);
        logz_out[b] = z;
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
// 4, NFF of 2; 4-byte loads where the scores or the lattice are not
// 16-byte aligned).  A step's posteriors come from the terms it computes for
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

// index in the output of element i of the scratch of (row b, segment
// starting at t0)
template <int S>
__device__ __forceinline__ size_t scratch_at(int i, int t0, int B, int b)
{
    return ((size_t)(t0 + i / S) * B + b) * S + i % S;
}

template <int NB, bool VEC>
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
        if (live) load_row<S, VEC>(cur, srow + t * rowstride);
    }
    for (int k = 0; k < K; ++k, --t) {
        const bool step = live && t >= t0;
        if constexpr (REG) {
            if (step && t > t0)
                load_row<S, VEC>(nxt, srow + (t - 1) * rowstride);
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

template <int NB, bool VEC>
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
    if constexpr (REG) load_row<S, VEC>(cur, srow + (t1 - 1) * rowstride);
    load_row<NFF, VEC>(fw, lrow + (t1 - 1) * lstride);
    for (int t = t1 - 1; t >= t0; --t) {
        if (t > t0) {
            if constexpr (REG) load_row<S, VEC>(nxt, srow + (t - 1) * rowstride);
            load_row<NFF, VEC>(nfw, lrow + (t - 1) * lstride);
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

// the forward with segments of K steps (the scratch may be null when T is
// one segment); VEC: the scores are 16-byte aligned
template <int NB, bool VEC>
int launch_fwd(const float* scores, float* fwd_final, float* logz,
               float* lattice, float* scratch, int T, int B, int K,
               cudaStream_t st)
{
    constexpr int G = Group<2 * NB>::G;
    const int nseg = T > K ? (T + K - 1) / K : 1;
    if (nseg > 1) {
        if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const size_t lanes = (size_t)B * (nseg - 1) * G;
        logz_fwd_transfer_kernel<NB, VEC>
            <<<(unsigned)((lanes + SEG_THREADS - 1) / SEG_THREADS),
               SEG_THREADS, 0, st>>>(scores, scratch, B, K, nseg);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        logz_fwd_boundary_kernel<NB>
            <<<(unsigned)(((size_t)B * G + SEG_THREADS - 1) / SEG_THREADS),
               SEG_THREADS, 0, st>>>(scratch, B, nseg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const size_t threads = (size_t)B * nseg;
    logz_fwd_rerun_kernel<NB, VEC>
        <<<(unsigned)((threads + POST_THREADS - 1) / POST_THREADS),
           POST_THREADS, 0, st>>>(scores, fwd_final, logz, lattice, scratch,
                                  T, B, K, nseg);
    return static_cast<int>(cudaGetLastError());
}

// the posteriors with segments of K steps; VEC: the scores and the lattice
// are 16-byte aligned
template <int NB, bool VEC>
int launch_post(const float* scores, const float* lattice, float* post,
                int T, int B, int K, cudaStream_t st)
{
    constexpr int G = Group<2 * NB>::G;
    const int nseg = (T + K - 1) / K;
    if (nseg > 1) {
        const size_t lanes = (size_t)B * (nseg - 1) * G;
        logz_transfer_kernel<NB, VEC>
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
    logz_post_kernel<NB, VEC>
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

// the forward's segment length K of a call: about T B / FWD_ROWS_STEPS
// steps within MIN_SEGMENT .. MAX_SEGMENT, so that the rerun (kernel C)
// runs some 8000 (row, segment) threads, as the posteriors' rule
// (probes/forward.py times K = 8 ... 64 on the card); one segment when T
// is that short
int tt_logz_fwd_segment(int T, int B, int nbase)
{
    (void)nbase;
    long long k = ((long long)T * B + FWD_ROWS_STEPS / 2) / FWD_ROWS_STEPS;
    k = k < MIN_SEGMENT ? MIN_SEGMENT : k > MAX_SEGMENT ? MAX_SEGMENT : k;
    return T <= k ? (T > 1 ? T : 1) : (int)k;
}

// the kernels a forward call launches: the transfers, the boundaries and
// the rerun, or the rerun alone when T is one segment
int tt_logz_fwd_kernels(int T, int B, int nbase)
{
    return T > tt_logz_fwd_segment(T, B, nbase) ? 3 : 1;
}

// the floats of the forward's scratch (0 when T is one segment)
int tt_logz_fwd_scratch(int T, int B, int nbase)
{
    const int K = tt_logz_fwd_segment(T, B, nbase);
    return (int)FwdScratch(B, 2 * nbase, T > K ? (T + K - 1) / K : 1).floats;
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

// scores [T, B, S] -> fwd_final [B, NFF], logz [B], lattice [T, B, NFF]
// (may be null), with segments of K steps (K <= 0: tt_logz_fwd_segment's)
// and the scratch of FwdScratch(B, NFF, nseg) floats.  Any contiguous f32
// scores (16-byte loads where aligned, else 4-byte).
int logz_fwd_launch(const float* scores, float* fwd_final, float* logz,
                    float* lattice, float* scratch, int T, int B, int nbase,
                    int K, cudaStream_t st)
{
    if (B == 0) return 0;
    if (K <= 0) K = tt_logz_fwd_segment(T, B, nbase);
    if (aligned16(scores)) {
#define TT_FWD(NB) launch_fwd<NB, true>(scores, fwd_final, logz, lattice, \
                                         scratch, T, B, K, st)
        TT_NBASE_CASES(TT_FWD)
#undef TT_FWD
    }
#define TT_FWD(NB) launch_fwd<NB, false>(scores, fwd_final, logz, lattice, \
                                          scratch, T, B, K, st)
    TT_NBASE_CASES(TT_FWD)
#undef TT_FWD
}

// scores [T, B, S], lattice [T, B, NFF] -> post [T, B, S], with segments of
// K steps (K <= 0: tt_logz_post_segment's; at least 2, so that a
// segment's rows hold the scratch of the next).  Any contiguous f32
// scores and lattice (16- and 8-byte loads where both are 16-byte
// aligned, else 4-byte).
int logz_post_launch(const float* scores, const float* lattice, float* post,
                     int T, int B, int nbase, int K, cudaStream_t st)
{
    if (B == 0 || T == 0) return 0;
    if (K <= 0) K = tt_logz_post_segment(T, B, nbase);
    if (K < 2) K = 2;
    if (aligned16(scores) && aligned16(lattice)) {
#define TT_POST(NB) launch_post<NB, true>(scores, lattice, post, T, B, K, st)
        TT_NBASE_CASES(TT_POST)
#undef TT_POST
    }
#define TT_POST(NB) launch_post<NB, false>(scores, lattice, post, T, B, K, st)
    TT_NBASE_CASES(TT_POST)
#undef TT_POST
}

extern "C" {

// scores [T, B, S] -> fwd_final [B, NFF], logz [B] (without log(nbase)),
// lattice [T, B, NFF] (may be null); scratch of tt_logz_fwd_scratch
// floats (null when that is 0).  Returns cudaGetLastError().
int tt_logz_fwd(const float* scores, float* fwd_final, float* logz,
                float* lattice, float* scratch, int T, int B, int nbase,
                void* stream)
{
    return logz_fwd_launch(scores, fwd_final, logz, lattice, scratch, T, B,
                           nbase, 0, static_cast<cudaStream_t>(stream));
}

// scores [T, B, S], lattice [T, B, NFF] -> post [T, B, S].
int tt_logz_posteriors(const float* scores, const float* lattice, float* post,
                       int T, int B, int nbase, void* stream)
{
    return logz_post_launch(scores, lattice, post, T, B, nbase, 0,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
