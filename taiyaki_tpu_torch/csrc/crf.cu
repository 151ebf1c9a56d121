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
// (S floats) is staged in shared memory and indexed directly.
//
// The forward (kernel 5) is a chain of T dependent steps, each a
// logaddexp at every position and a max over the row: see crf_chain_kernel.
// The lattice it writes is the bytes bound (0.42 GB at T=800, B=256,
// L=512, ~0.13 ms of device memory time); the chain's arithmetic at every
// position (~50 instructions a position and step, issued on B rows' SMs)
// bounds it near ~0.2 ms there.
//
// The backward (kernel 6) runs the same kind of chain backwards, one
// barrier a step, and takes the posteriors off it: see crf_bwd_kernel.

// Kernels 9-10 (tt_crf_fwd_streams; tt_crf_bwd_posteriors and
// tt_crf_grad_streams) replace the unfused TPU kernels pallas_crf.py:108
// `crf_forward` and pallas_crf.py:218 `crf_backward_posteriors`: the same
// recursions on pre-selected f32 score streams stay [T, B, L] and move [T,
// B, L] (column l the move l -> l+1), which the caller gathers from lp
// (ops/flipflop.py).  The forward is kernel 5's chain on another reader;
// the backward runs that chain backwards into a backward lattice, then a
// posterior pass without a serial chain that writes the posteriors
// post_stay and post_move [T, B, L] of each step's 2L-1 transitions, or
// sums them into d lp [T, B, S] in a fixed order: see "kernels 9-10"
// below.  Positions are masked by index (l == 0, valid[l], l < last),
// never by the padding value of a stream.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr int MAX_S = 128;
constexpr int MAX_L = 8192;      // the fused kernels' widest lattice

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

// a move's score with its weighted cat_mod column, rounded after the
// product and after the sum (no fused multiply-add), as the plain twins
// and the streams route's gather compute it, so that the two routes see
// the same scores
__device__ __forceinline__ float mod_fold(float move, float fact, float mod)
{
    return __fadd_rn(move, __fmul_rn(fact, mod));
}

// score of column idx in the staged row (0 outside [0, S))
__device__ __forceinline__ float pick(const float* row, int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? row[idx] : 0.f;
}

// a position's columns and flags packed in one word: stay column, move
// column (bits 8..15), weighted mod column (16..23), each in [0, S] (S
// selecting nothing), the position valid (OK_BIT) and its move live
// (MOK_BIT)
constexpr unsigned OK_BIT = 1u << 24, MOK_BIT = 1u << 25;

// column index in [0, S], S for one outside [0, S) (it selects nothing)
__device__ __forceinline__ unsigned col8(int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? (unsigned)idx : (unsigned)S;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A phase clock for the probes: PhaseClock<true, N> sums one thread's
// cycles in each of N phases (clock64); PhaseClock<false, N>, the
// kernels' own, compiles to nothing.
template <bool ON, int N>
struct PhaseClock {
    __device__ __forceinline__ void start() {}
    __device__ __forceinline__ void lap(int) {}
    __device__ __forceinline__ void store(long long*, size_t) {}
};

template <int N>
struct PhaseClock<true, N> {
    long long sum[N] = {};
    long long last = 0;
    __device__ __forceinline__ void start() { last = clock64(); }
    __device__ __forceinline__ void lap(int phase)
    {
        const long long now = clock64();
        sum[phase] += now - last;
        last = now;
    }
    __device__ __forceinline__ void store(long long* out, size_t row)
    {
        for (int i = 0; i < N; ++i) out[row * N + i] = sum[i];
    }
};

// ---- the chain: kernel 5, kernel 9 and kernel 10's backward recursion -----
//
// One template runs the three serial recursions; they differ only in where
// a step's scores come from (the reader, below) and in the direction.
//
// Kernel 5 replaces pallas_crf.py:423 `crf_forward_fused`; on score
// streams the forward is kernel 9 (pallas_crf.py:108 `crf_forward`) and
// the backward recursion the chain of kernel 10 (pallas_crf.py:218
// `crf_backward_posteriors`).  Forward, per step t: new[l] =
// logaddexp(fwd[l] + stay[l], fwd[l-1] + move[l-1]) at every valid
// position, its max over the row (the step's factor, summed into the
// score), fwd = new - factor; lattice[t] is fwd before the step.
// Backward (BWD), per step from t = T-1 down: new[l] = logaddexp(stay[l] +
// bwd[l], move[l] + bwd[l+1]), the move out of l only for l < last,
// renormalised the same way; lattice[t] is bwd before the step (the
// backward lattice, which the posterior pass reads).
//
// Layout: CL CTAs of NT threads a row (a thread-block cluster past 4096
// positions), P consecutive positions a thread, l = (rank NT + tid) P + p;
// NT is the launch's, at most the instance's MAXNT, the fewest warps that
// hold L.  The state lives in registers, renormalised: the neighbour
// position (l - 1 forward, l + 1 backward) is the same thread's, or the
// next lane's (__shfl_up_sync / __shfl_down_sync), and only a warp's edge
// lane needs the neighbour warp's edge value, which it reads from shared
// memory after the step's one barrier; that barrier also gives the block
// max (one redux a warp, one more over the warps' maxima).  With MAXNT = 32
// a row is one warp and needs no barrier at all (FWD_WARP_ROWS rows a
// block); with CL > 1 the barrier is the cluster's, the other CTAs' maxima
// and edge values read through distributed shared memory.
//
// What bounds it is the positions' arithmetic, issued on the SMs of B
// rows: a logaddexp (accurate expf and log1pf, some 50 instructions) at
// every position and step.  probes/forward.py measured kernel 5's layouts
// by L (PERF.md): 2 positions a thread beat 4 to 16 up to 2048 positions
// (more warps to hide the chain's latency), one warp a row lost to more
// warps with a barrier, and the cluster won only past 4096 positions, where
// one CTA would need 8 positions a thread and spill.
//
// No step waits on device memory.  Kernel 5 (LpReader): the lp rows of K
// steps (a batch) go by cp.async into a ring of two batches in shared
// memory, one batch ahead (16 bytes a copy where S is a multiple of 4 and
// lp 16-byte aligned, else 4), each row padded with a zero at column S, so
// a column outside [0, S) reads 0 without a compare.  Kernels 9-10
// (StreamReader): each thread copies its own positions' stay and move
// scores (and, forward, lane 0 the move into its first position) by
// cp.async into its own slots of a ring K steps ahead, one commit group a
// step, and waits only on its own group, so the copies need no barrier (4P
// bytes a copy where L is a multiple of P and the streams 4P-byte aligned,
// else 4).  The lattice rows go out as 16-byte stores where L is a
// multiple of 4, else 4-byte.
//
// Arithmetic as the plain twins': the mod fold rounded as `mod_fold`, the
// logaddexp as `logaddexpf_`, the exact max of the step, impossible states
// NEG, so the lattice matches the twin to rounding.  (FAST, the probe's
// alone: __expf and __logf, which missed the lattice's 1e-4 by 5-20x.)

constexpr int FWD_WARP_ROWS = 4;   // rows a block where a row is one warp
constexpr int FWD_BATCH = 16;      // steps of lp rows a batch (kernel 5)
// the phase clock's: score wait, lattice stores, positions, barrier
constexpr int FWD_PHASES = 4;
// floats before the reader's ring: the maxima and the edge values, [2][32]
// each
constexpr int CHAIN_RED = 128;
constexpr int STREAM_BATCH_MAX = 8; // steps a batch of a stream ring

__device__ __forceinline__ float logaddexp_fast(float a, float b)
{
    const float m = fmaxf(a, b);
    return m + __logf(1.f + __expf(-fabsf(a - b)));
}

// the max of v over the warp: one redux on the floats' order-keeping ints
__device__ __forceinline__ float warp_max_redux(float v)
{
    int k = __float_as_int(v);
    k ^= (k >> 31) & 0x7fffffff;
    k = __reduce_max_sync(FULL, k);
    k ^= (k >> 31) & 0x7fffffff;
    return __int_as_float(k);
}

// floats of an lp row in the ring: S and a zero, rounded up to 16 bytes
__host__ __device__ inline int fwd_row_floats(int S) { return (S + 4) & ~3; }

// lp rows t0 .. t0 + n - 1 of row b into dst (rows of SP floats), by the
// NT threads of the row (rt its thread)
__device__ __forceinline__ void fwd_copy_rows(float* dst, const float* lp,
                                              int t0, int n, int B, int S,
                                              int SP, int b, bool wide,
                                              int rt, int NT)
{
    if (wide) {
        const int q = S / 4;
        for (int i = rt; i < n * q; i += NT) {
            const int k = i / q, j = i - k * q;
            cp_async16(dst + k * SP + 4 * j,
                       lp + ((size_t)(t0 + k) * B + b) * S + 4 * j);
        }
    } else {
        for (int i = rt; i < n * S; i += NT) {
            const int k = i / S, j = i - k * S;
            cp_async4(dst + k * SP + j, lp + ((size_t)(t0 + k) * B + b) * S
                                             + j);
        }
    }
}

// P values of positions l0 .. l0 + P - 1 into out (a row of L): 16-byte
// stores where L is a multiple of 4 (then out is 16-byte aligned), else
// 4-byte, none past L
template <int P>
__device__ __forceinline__ void fwd_store(float* out, int l0, const float* v,
                                          int L)
{
    if (P % 4 == 0 && (L & 3) == 0) {
#pragma unroll
        for (int q = 0; q < P / 4; ++q)
            if (l0 + 4 * q < L)
                *reinterpret_cast<float4*>(out + l0 + 4 * q) = make_float4(
                    v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
            if (l0 + p < L) out[l0 + p] = v[p];
    }
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// P consecutive floats in copies of 16 bytes (P a multiple of 4), else of
// 4P bytes (P = 1 or 2); both ends aligned to that
template <int P>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src)
{
    if (P % 4 == 0) {
#pragma unroll
        for (int q = 0; q < P; q += 4) cp_async16(dst + q, src + q);
    } else if (P == 2) {
        cp_async8(dst, src);
    } else {
#pragma unroll
        for (int p = 0; p < P; ++p) cp_async4(dst + p, src + p);
    }
}

// P consecutive floats of shared memory into v, as cp_async_vec copies them
template <int P>
__device__ __forceinline__ void ld_vec(float* v, const float* src)
{
    if (P % 4 == 0) {
#pragma unroll
        for (int q = 0; q < P; q += 4) {
            const float4 x = *reinterpret_cast<const float4*>(src + q);
            v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
        }
    } else if (P == 2) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        v[0] = x.x; v[1] = x.y;
    } else {
#pragma unroll
        for (int p = 0; p < P; ++p) v[p] = src[p];
    }
}

// Kernel 5's scores: lp [T, B, S] and each position's columns.
struct LpSource {
    const float* lp;
    const int* stay_idx;
    const int* move_idx;
    const int* mod_idx;
    const float* mod_fact;
    int S;
};

// Kernels 9-10's scores: the stay and move streams [T, B, L] (move column
// l the move l -> l+1).
struct StreamSource {
    const float* stay;
    const float* move;
};

// A thread's view of a step's scores, one reader a source.  Each gives the
// position flags (ok: valid; mok: its move live), and per step the stay
// score of each of the thread's positions and the score of the move that
// the recursion adds at it (into l forward, out of l backward).
template <int P>
struct LpReader {
    using Src = LpSource;
    static constexpr bool BATCH_SYNC = true;   // a row barrier a batch
    // per position: its packed columns and flags, the weight of its mod
    // column
    unsigned pw[P];
    float mf[P];
    const float* lp;
    float* ring;
    const float* rows;
    const float* row;
    int S, SP, K, T, B, b, rt, NT;
    bool wide;

    // the ring's floats: two batches of K lp rows, a ring a row
    static size_t ring_floats(int rowsb, int ntb, int K_, int S_)
    {
        (void)ntb;
        return (size_t)rowsb * 2 * K_ * fwd_row_floats(S_);
    }

    __device__ void init(const LpSource& src, float* smem_ring,
                         const int* valid, int last, size_t rowoff, int l0,
                         int L, int T_, int B_, int K_, int b_, int rt_,
                         int NT_, int ringrow)
    {
        (void)last;
        lp = src.lp;
        S = src.S;
        SP = fwd_row_floats(S);
        K = K_;
        T = T_;
        B = B_;
        b = b_;
        rt = rt_;
        NT = NT_;
        ring = smem_ring + (size_t)ringrow * 2 * K * SP;
        wide = S % 4 == 0 && (reinterpret_cast<size_t>(lp) & 15) == 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = l0 + p;
            unsigned w = (unsigned)S | (unsigned)S << 8 | (unsigned)S << 16;
            float fact = 0.f;
            if (l < L) {
                const bool ok = valid[rowoff + l] != 0;
                w = col8(src.stay_idx[rowoff + l], S);
                if (l > 0) {
                    const bool mok = ok && valid[rowoff + l - 1] != 0;
                    w |= col8(src.move_idx[rowoff + l - 1], S) << 8
                        | col8(src.mod_idx[rowoff + l - 1], S) << 16
                        | (mok ? MOK_BIT : 0u);
                    fact = src.mod_fact[rowoff + l - 1];
                } else {
                    w |= (unsigned)S << 8 | (unsigned)S << 16;
                }
                w |= ok ? OK_BIT : 0u;
            }
            pw[p] = w;
            mf[p] = fact;
        }
    }
    __device__ bool ok(int p) const { return pw[p] & OK_BIT; }
    __device__ bool mok(int p) const { return pw[p] & MOK_BIT; }

    // the ring's padding columns read 0; the first batch's rows
    __device__ void start()
    {
        for (int i = rt; i < 2 * K; i += NT)
            for (int j = S; j < SP; ++j) ring[i * SP + j] = 0.f;
        fwd_copy_rows(ring, lp, 0, min(K, T), B, S, SP, b, wide, rt, NT);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // at a batch of steps s0 ..: its rows have landed and every thread of
    // the row is done with the last batch's (the caller's wait and row
    // barrier); the next batch's rows start
    __device__ void batch(int s0)
    {
        rows = ring + ((s0 / K) & 1) * K * SP;
        if (s0 + K < T)
            fwd_copy_rows(ring + (((s0 / K) & 1) ^ 1) * K * SP, lp, s0 + K,
                          min(K, T - s0 - K), B, S, SP, b, wide, rt, NT);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    __device__ void step(int s, int k)
    {
        (void)s;
        row = rows + k * SP;
    }
    __device__ float stay(int p) const { return row[pw[p] & 0xff]; }
    __device__ float move(int p) const
    {
        const unsigned w = pw[p], mc = (w >> 16) & 0xff;
        const float mv = row[(w >> 8) & 0xff];
        return mc < (unsigned)S ? mod_fold(mv, mf[p], row[mc]) : mv;
    }
};

// floats of a step's slot of the stream ring: stay [ntb][P], move
// [ntb][P], the move into each warp's first position [ntb / 32], rounded
// up to 16 bytes
__host__ __device__ inline int stream_slot_floats(int ntb, int P)
{
    return (2 * ntb * P + ntb / 32 + 3) & ~3;
}

template <int P, bool BWD>
struct StreamReader {
    using Src = StreamSource;
    static constexpr bool BATCH_SYNC = false;  // each thread its own slots
    unsigned flags;       // bit p: position l0 + p valid; bit P + p: its move
    const float* sp;      // the streams at (t = 0, row b, l0)
    const float* mp;
    float* ring;          // [2][K][slot]
    const float* rows;    // this batch's half
    size_t tstride;
    int K, T, SF, ntb, tix, nvalid;
    bool wide, xtra;
    float sv[P], mo[P], mv0;

    // the ring's floats: two batches of K steps' slots
    static size_t ring_floats(int rowsb, int ntb_, int K_, int S_)
    {
        (void)rowsb;
        (void)S_;
        return (size_t)2 * K_ * stream_slot_floats(ntb_, P);
    }

    __device__ void init(const StreamSource& src, float* smem_ring,
                         const int* valid, int last, size_t rowoff, int l0,
                         int L, int T_, int B, int K_, int b, int rt,
                         int NT, int ringrow)
    {
        (void)b;
        (void)rt;
        (void)NT;
        (void)ringrow;
        ntb = blockDim.x;
        tix = threadIdx.x;
        K = K_;
        T = T_;
        SF = stream_slot_floats(ntb, P);
        ring = smem_ring;
        tstride = (size_t)B * L;
        sp = src.stay + rowoff + l0;
        mp = src.move + rowoff + l0;
        nvalid = L - l0;      // positions of this thread inside the row
        wide = (P == 2 || P % 4 == 0) && L % P == 0
            && ((reinterpret_cast<size_t>(src.stay)
                 | reinterpret_cast<size_t>(src.move)) & (4 * P - 1)) == 0;
        // forward: lane 0 copies the move into its first position
        xtra = !BWD && (tix & 31) == 0 && l0 > 0 && l0 <= L;
        flags = 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int l = l0 + p;
            if (l < L && valid[rowoff + l] != 0)
                flags |= 1u << p
                    | ((BWD ? l < last : l > 0) ? 1u << (P + p) : 0u);
        }
    }
    __device__ bool ok(int p) const { return (flags >> p) & 1; }
    __device__ bool mok(int p) const { return (flags >> (P + p)) & 1; }

    // steps s0 .. s0 + K - 1's scores (none past T) into ring half h, one
    // commit group
    __device__ void copy(int s0, int h)
    {
        for (int k = 0; k < K && s0 + k < T; ++k) {
            const int s = s0 + k;
            const size_t off = (size_t)(BWD ? T - 1 - s : s) * tstride;
            float* dst = ring + (size_t)(h * K + k) * SF;
            float* ds = dst + tix * P;
            float* dm = dst + ntb * P + tix * P;
            if (wide && nvalid >= P) {
                cp_async_vec<P>(ds, sp + off);
                cp_async_vec<P>(dm, mp + off);
            } else {
#pragma unroll
                for (int p = 0; p < P; ++p)
                    if (p < nvalid) {
                        cp_async4(ds + p, sp + off + p);
                        cp_async4(dm + p, mp + off + p);
                    }
            }
            if (xtra) cp_async4(dst + 2 * ntb * P + (tix >> 5), mp + off - 1);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    __device__ void start() { copy(0, 0); }
    // a batch of steps s0 ..: the next batch's copies start (into the half
    // this thread read last batch), this one's have landed
    __device__ void batch(int s0)
    {
        const int h = (s0 / K) & 1;
        if (s0 + K < T)
            copy(s0 + K, h ^ 1);
        else
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        rows = ring + (size_t)h * K * SF;
    }
    __device__ void step(int s, int k)
    {
        (void)s;
        const float* slot = rows + (size_t)k * SF;
        ld_vec<P>(sv, slot + tix * P);
        ld_vec<P>(mo, slot + ntb * P + tix * P);
        if (!BWD) {
            mv0 = __shfl_up_sync(FULL, mo[P - 1], 1);
            if ((tix & 31) == 0) mv0 = xtra ? slot[2 * ntb * P + (tix >> 5)]
                                            : 0.f;
        }
    }
    __device__ float stay(int p) const { return sv[p]; }
    __device__ float move(int p) const
    {
        return BWD ? mo[p] : p == 0 ? mv0 : mo[p > 0 ? p - 1 : 0];
    }
};

template <int MAXNT, int P, int CL, bool FAST, bool CLOCK, bool BWD,
          class RD>
__global__ void __launch_bounds__(MAXNT == 32 ? 32 * FWD_WARP_ROWS : MAXNT)
crf_chain_kernel(typename RD::Src src, const int* __restrict__ valid,
                 const int* __restrict__ lastpos,
                 float* __restrict__ fwd_final,
                 float* __restrict__ score_out, float* __restrict__ lattice,
                 int T, int B, int L, int K, long long* __restrict__ cyc)
{
    static_assert(MAXNT % 32 == 0 && (CL == 1 || MAXNT > 32), "layout");
    const int NT = MAXNT == 32 ? 32 : blockDim.x, NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the row, this CTA's rank in it, the thread in the row's CTA
    const int b = MAXNT == 32 ? blockIdx.x * FWD_WARP_ROWS + warp
                              : blockIdx.x / CL;
    const int rank = CL == 1 ? 0 : blockIdx.x % CL;
    const int rt = MAXNT == 32 ? lane : threadIdx.x;
    if (MAXNT == 32 && b >= B) return;  // a whole warp, which syncs alone
    float* red = smem;                  // [2][NW] maxima (MAXNT > 32)
    float* edge = smem + 64;            // [2][NW] a warp's edge new value
    const size_t rowoff = (size_t)b * L;
    const int l0 = (rank * NT + rt) * P;
    const int last = BWD ? lastpos[b] : 0;
    PhaseClock<CLOCK, FWD_PHASES> clk;
    auto row_sync = [&]() {
        if (MAXNT == 32)
            __syncwarp();
        else
            __syncthreads();
    };

    RD rd;
    rd.init(src, smem + CHAIN_RED, valid, last, rowoff, l0, L, T, B, K, b,
            rt, NT, MAXNT == 32 ? warp : 0);
    // the state: 0 at the start position (0 forward, last backward)
    float f[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
        f[p] = (rd.ok(p) && l0 + p == (BWD ? last : 0)) ? 0.f : NEG;
    rd.start();

    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    float score = 0.f;
    // the edge lane's neighbour position in the next warp (lane 0 the
    // position below forward, lane 31 the one above backward), renormalised;
    // before the first step the start vector's (0 at last backward)
    float nbr = NEG;
    if (BWD && lane == 31 && l0 + P == last && last < L
            && valid[rowoff + last] != 0)
        nbr = 0.f;
    clk.start();
    for (int s0 = 0; s0 < T; s0 += K) {
        const int n = min(K, T - s0);
        if (RD::BATCH_SYNC) {
            cp_async_wait_all();
            row_sync();
        }
        rd.batch(s0);
        clk.lap(0);

        for (int k = 0; k < n; ++k) {
            const int s = s0 + k, t = BWD ? T - 1 - s : s, par = s & 1;
            rd.step(s, k);
            clk.lap(0);
            if (lattice != nullptr)
                fwd_store<P>(lattice + ((size_t)t * B + b) * L, l0, f, L);
            clk.lap(1);
            float nb;
            if (BWD) {
                nb = __shfl_down_sync(FULL, f[0], 1);
                if (lane == 31) nb = nbr;
            } else {
                nb = __shfl_up_sync(FULL, f[P - 1], 1);
                if (lane == 0) nb = nbr;
            }
            float nw[P], m = NEG;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const float stay = f[p] + rd.stay(p);
                const float mv = rd.move(p);
                const float other = BWD ? (p == P - 1 ? nb : f[p < P - 1 ? p + 1 : 0])
                                        : (p == 0 ? nb : f[p > 0 ? p - 1 : 0]);
                const float move = rd.mok(p) ? other + mv : NEG;
                nw[p] = rd.ok(p) ? (FAST ? logaddexp_fast(stay, move)
                                         : logaddexpf_(stay, move))
                                 : NEG;
                m = fmaxf(m, nw[p]);
            }
            m = warp_max_redux(m);
            clk.lap(2);
            float factor = m;
            if (MAXNT > 32) {
                if (lane == 0) red[par * NW + warp] = m;
                if (lane == (BWD ? 0 : 31))
                    edge[par * NW + warp] = BWD ? nw[0] : nw[P - 1];
                if (CL == 1)
                    __syncthreads();
                else
                    cluster.sync();
                float r = lane < NW ? red[par * NW + lane] : NEG;
                if (CL > 1 && lane < NW) {
#pragma unroll
                    for (int c = 0; c < CL; ++c)
                        if (c != rank)
                            r = fmaxf(r, cluster.map_shared_rank(red, c)[
                                             par * NW + lane]);
                }
                factor = warp_max_redux(r);
                if (lane == (BWD ? 31 : 0)) {
                    float e = NEG;
                    if (BWD) {
                        if (warp + 1 < NW)
                            e = edge[par * NW + warp + 1];
                        else if (CL > 1 && rank + 1 < CL)
                            e = cluster.map_shared_rank(edge, rank + 1)[
                                par * NW];
                    } else {
                        if (warp > 0)
                            e = edge[par * NW + warp - 1];
                        else if (CL > 1 && rank > 0)
                            e = cluster.map_shared_rank(edge, rank - 1)[
                                par * NW + NW - 1];
                    }
                    nbr = e - factor;
                }
            }
#pragma unroll
            for (int p = 0; p < P; ++p)
                f[p] = rd.ok(p) ? nw[p] - factor : NEG;
            score += factor;
            clk.lap(3);
        }
    }
    if (!BWD) {
        fwd_store<P>(fwd_final + rowoff, l0, f, L);
        if (rank == 0 && rt == 0) score_out[b] = score;
    }
    if (CLOCK && rank == 0 && rt == 0) clk.store(cyc, b);
    // another CTA of the row may still read this one's shared memory
    if (CL > 1) cluster.sync();
}

// the threads a row of an instance of at most MAXNT threads: the fewest
// warps that hold L at P positions a thread and CL CTAs a row (at least
// two, so that a barrier-free warp row stays MAXNT = 32's)
template <int MAXNT, int P, int CL>
int fwd_threads(int L)
{
    if (MAXNT == 32) return 32;
    const int warps = (L + 32 * P * CL - 1) / (32 * P * CL);
    return 32 * (warps < 2 ? 2 : warps);
}

// the chain's dynamic shared memory on NT threads a row, ring depth K
template <class RD>
size_t chain_smem(int NT, int K, int S)
{
    const int rowsb = NT == 32 ? FWD_WARP_ROWS : 1;
    const int ntb = NT == 32 ? 32 * FWD_WARP_ROWS : NT;
    return sizeof(float) * (CHAIN_RED + RD::ring_floats(rowsb, ntb, K, S));
}

template <int MAXNT, int P, int CL, bool FAST, bool CLOCK, bool BWD,
          class RD>
int launch_chain(typename RD::Src src, const int* valid, const int* last,
                 float* fwd_final, float* score, float* lattice, int T,
                 int B, int L, int K, int NT, int S, long long* cyc,
                 cudaStream_t st)
{
    if (K < 1 || NT > MAXNT || NT % 32 || (MAXNT == 32) != (NT == 32)
            || L > NT * P * CL)
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = crf_chain_kernel<MAXNT, P, CL, FAST, CLOCK, BWD, RD>;
    const size_t smem = chain_smem<RD>(NT, K, S);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(NT == 32 ? (B + FWD_WARP_ROWS - 1) / FWD_WARP_ROWS
                                : B * CL);
    cfg.blockDim = dim3(NT == 32 ? 32 * FWD_WARP_ROWS : NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = CL > 1 ? 1 : 0;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, src, valid, last,
                                       fwd_final, score, lattice, T, B, L, K,
                                       cyc);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// kernel 5 on NT threads a row, K steps of lp rows a batch
template <int MAXNT, int P, int CL, bool FAST, bool CLOCK>
int launch_fwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const int* valid,
               float* fwd_final, float* score, float* lattice, int T, int B,
               int S, int L, int K, int NT, long long* cyc, cudaStream_t st)
{
    return launch_chain<MAXNT, P, CL, FAST, CLOCK, false, LpReader<P>>(
        LpSource{lp, sidx, midx, mmidx, mfact, S}, valid, nullptr,
        fwd_final, score, lattice, T, B, L, K, NT, S, cyc, st);
}

// ---- kernel 6: the backward, its posteriors off the chain ----------------
//
// Replaces pallas_crf.py:565 `crf_backward_fused`.  The chain does only
// the backward recursion: per step, new[l] = logaddexp(stay[l] + bwd[l],
// move[l] + bwd[l+1]) over the positions, then its block max, one
// barrier.  Its
// unrenormalised vectors go into a ring of K + 1 in shared memory with
// their normalisers, and every K steps (a batch) the block forms those K
// steps' posteriors at once, in parallel, off the chain:
//   pass A  each position's stay and move terms, (fc + bwd) + score, fc
//           the forward lattice row (copied in by cp.async while the chain
//           ran), the stay term in place of fc, the move term in a
//           register; each step's largest term; one barrier;
//   exp     each position's own two exponentials, in place: the stay one
//           over its term, the move one over the position's entry of its
//           step's vector (every read of the vectors is done); one barrier;
//   pass B  each (step, chunk) sum of those exponentials over the
//           contributions to one column of d lp, grouped once per row at
//           the start by a stable counting sort (column, then position,
//           then stay / move / weighted mod), chunks of CHUNK entries, each
//           chunk summed in its order by one thread;
//   grad    one warp a step: the denominator (every chunk's stay and move
//           sums, lanes strided then a butterfly), each column the sum of
//           its chunks in order, divided, stored.
// No float atomics: every sum is taken in an order fixed by the row's
// indices, so d lp is bitwise the same from run to run.  The indices
// live in shared memory (one packed word and the mod weight a position),
// not in registers, so L = 8192 spills nothing.  A batch's lp rows are
// copied in by cp.async (4 bytes each: an lp row of S = 46 is 184 bytes)
// one batch ahead, its lattice rows (16 bytes each where L is a multiple
// of 4, else 4) during its chain, so the chain never waits on device
// memory.
//
// Bound: the chain (T steps of a logaddexp and a block max) and the
// passes' arithmetic (~2L exponentials a step, issued beside the chain of
// the SM's other block); bytes (lp read, d lp written, the lattice read
// once: 0.11 ms at T=800, B=256, L=512) are far below.  K is 16 where
// two blocks fit an SM's shared memory and the move terms KR x P <= 32
// registers (L <= 512), fewer past that (1 at L = 8192); threads: 256,
// or 512 past 2048 positions.  probes/posteriors.py times its phases.

// entries of a column list a chunk: odd, so that the chunks a warp's lanes
// sum start in different shared-memory banks
constexpr int CHUNK = 31;
constexpr int BWD_BATCH = 16;      // steps a batch, where shared memory allows
constexpr size_t BWD_SMEM_SHARED = 100 * 1024;   // two blocks an SM
constexpr size_t BWD_SMEM_MAX = 232448;          // one block an SM

__host__ __device__ inline int bwd_chunks(int L, int S)
{
    return (3 * L + CHUNK - 1) / CHUNK + S + 1;
}

// byte offsets of the backward's shared memory, each 16-byte aligned
struct BwdLayout {
    size_t parts, ring, fcs, prevs, lps, red_c, red_a, mf, pw, off, choff,
        cnt, chst, ent, bytes;
    __host__ __device__ static size_t take(size_t& o, size_t n)
    {
        const size_t at = o;
        o += (n + 15) & ~(size_t)15;
        return at;
    }
    __host__ __device__ BwdLayout(int L, int S, int K, int NW)
    {
        const size_t nch = bwd_chunks(L, S), f = sizeof(float);
        size_t o = 0;
        parts = take(o, sizeof(float2) * K * nch);   // [K][nch]
        // [K+1][L] bwd vectors; a batch's become its move exponentials
        ring = take(o, f * (K + 1) * L);
        // [K][L] a batch's lattice rows, then its stay terms, exponentials
        fcs = take(o, f * K * L);
        prevs = take(o, f * (K + 1));
        lps = take(o, f * 2 * K * S);                // [2][K][S]
        red_c = take(o, f * 2 * NW);
        red_a = take(o, f * K * NW);
        mf = take(o, f * L);
        pw = take(o, sizeof(unsigned) * L);
        off = take(o, sizeof(int) * (S + 2));
        choff = take(o, sizeof(int) * (S + 2));
        cnt = take(o, sizeof(int) * (S + 1));
        chst = take(o, sizeof(unsigned short) * (nch + 1));
        ent = take(o, sizeof(unsigned short) * 3 * L);
        bytes = o;
    }
};

// The phase clock of the backward, for probes/posteriors.py: BwdClock<true>
// sums thread 0's cycles in each phase of a batch (the wait for its lp
// rows, the chain's arithmetic, the chain's barriers, the wait for its
// lattice rows, pass A, the exponentials, pass B, the grad rows);
// BwdClock<false>, the kernel's own, compiles to nothing.
constexpr int BWD_PHASES = 8;

template <bool ON>
using BwdClock = PhaseClock<ON, BWD_PHASES>;

// which of position l's contributions (bit 0 stay, 1 move, 2 weighted
// mod) go to column j; column S collects stays and moves whose index
// selects nothing (they count in the denominator only)
__device__ __forceinline__ unsigned contributions(unsigned w, float mf, int j,
                                                  int S)
{
    unsigned m = 0;
    if ((w & OK_BIT) && (w & 0xff) == (unsigned)j) m |= 1;
    if (w & MOK_BIT) {
        if (((w >> 8) & 0xff) == (unsigned)j) m |= 2;
        if (j < S && mf != 0.f && ((w >> 16) & 0xff) == (unsigned)j) m |= 4;
    }
    return m;
}

__device__ __forceinline__ float stay_score(const float* row, unsigned w,
                                            int S)
{
    return pick(row, w & 0xff, S);
}

// the move's score, with its weighted mod column where one is selected
// (mod_fold of a column selecting nothing adds fact x 0: the same value)
__device__ __forceinline__ float move_score(const float* row, unsigned w,
                                            const float* mf, int S)
{
    const float move = pick(row, (w >> 8) & 0xff, S);
    const unsigned mc = (w >> 16) & 0xff;
    return mc < (unsigned)S ? mod_fold(move, *mf, row[mc]) : move;
}

// lattice rows of steps s, s + 1, ... (n of them) of row b: 16 bytes a
// copy where the rows are 16-byte aligned (L a multiple of 4), else 4
template <int NT>
__device__ __forceinline__ void copy_lattice(float* dst, const float* lattice,
                                             int s, int n, int T, int B,
                                             int L, int b, bool wide)
{
    if (wide) {
        const int q = L / 4;
        for (int i = threadIdx.x; i < n * q; i += NT) {
            const int k = i / q, j = i - k * q;
            cp_async16(dst + k * L + 4 * j,
                       lattice + ((size_t)(T - 1 - s - k) * B + b) * L
                           + 4 * j);
        }
    } else {
        for (int i = threadIdx.x; i < n * L; i += NT) {
            const int k = i / L, j = i - k * L;
            cp_async4(dst + i,
                      lattice + ((size_t)(T - 1 - s - k) * B + b) * L + j);
        }
    }
}

// lp rows of steps s, s + 1, ... (n of them; t = T - 1 - s) of row b
template <int NT>
__device__ __forceinline__ void copy_rows(float* dst, const float* lp, int s,
                                          int n, int T, int B, int S, int b)
{
    for (int i = threadIdx.x; i < n * S; i += NT) {
        const int k = i / S, j = i - k * S;
        cp_async4(dst + i, lp + ((size_t)(T - 1 - s - k) * B + b) * S + j);
    }
}

// steps a batch at most, P positions a thread: the move terms of a batch
// wait in KR x P <= 32 registers (at P = 1, 8 steps: with 16 the compiler
// kept part of the unrolled batch in local memory)
__host__ __device__ constexpr int bwd_batch_max(int P)
{
    return P == 1 ? 8 : 32 / P < BWD_BATCH ? 32 / P : BWD_BATCH;
}

template <int NT, int P, bool CLOCK = false>
__global__ void __launch_bounds__(NT)
crf_bwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const float* __restrict__ lattice,
               const int* __restrict__ valid, const int* __restrict__ lastpos,
               float* __restrict__ grad, int T, int B, int S, int L, int K,
               long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32, KR = bwd_batch_max(P);
    extern __shared__ __align__(16) float smem_f[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
    const BwdLayout lay(L, S, K, NW);
    float2* parts = reinterpret_cast<float2*>(smem + lay.parts);
    float* ring = reinterpret_cast<float*>(smem + lay.ring);
    float* fcs = reinterpret_cast<float*>(smem + lay.fcs);
    float* prevs = reinterpret_cast<float*>(smem + lay.prevs);
    float* lps = reinterpret_cast<float*>(smem + lay.lps);
    float* red_c = reinterpret_cast<float*>(smem + lay.red_c);
    float* red_a = reinterpret_cast<float*>(smem + lay.red_a);
    float* mf = reinterpret_cast<float*>(smem + lay.mf);
    unsigned* pw = reinterpret_cast<unsigned*>(smem + lay.pw);
    int* off = reinterpret_cast<int*>(smem + lay.off);
    int* choff = reinterpret_cast<int*>(smem + lay.choff);
    int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
    unsigned short* chst = reinterpret_cast<unsigned short*>(smem + lay.chst);
    unsigned short* ent = reinterpret_cast<unsigned short*>(smem + lay.ent);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    const size_t rowoff = (size_t)b * L;
    const int last = lastpos[b];
    const int R = K + 1;
    const bool wide = L % 4 == 0
        && reinterpret_cast<size_t>(lattice) % 16 == 0;
    BwdClock<CLOCK> clk;

    // per position: the packed columns and flags, the mod weight, the
    // first vector (ring slot 0); the first batch's lp rows
    for (int l = tid; l < L; l += NT) {
        const bool ok = valid[rowoff + l] != 0;
        const bool mok = ok && l < last && l + 1 < L
            && valid[rowoff + l + 1] != 0;
        pw[l] = col8(stay_idx[rowoff + l], S)
            | col8(move_idx[rowoff + l], S) << 8
            | col8(mod_idx[rowoff + l], S) << 16
            | (ok ? OK_BIT : 0u) | (mok ? MOK_BIT : 0u);
        mf[l] = mod_fact[rowoff + l];
        ring[l] = (l == last && ok) ? 0.f : NEG;
    }
    if (tid == 0) prevs[0] = 0.f;
    copy_rows<NT>(lps, lp, 0, min(K, T), T, B, S, b);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    __syncthreads();

    // the column lists: warp w counts and then fills columns w, w + NW, ...
    for (int j = warp; j <= S; j += NW) {
        int n = 0;
        for (int base = 0; base < L; base += 32) {
            const int l = base + lane;
            const unsigned m = l < L ? contributions(pw[l], mf[l], j, S) : 0;
            n += __reduce_add_sync(FULL, __popc(m));
        }
        if (lane == 0) cnt[j] = n;
    }
    __syncthreads();
    if (tid == 0) {
        int run = 0, crun = 0;
        for (int j = 0; j <= S; ++j) {
            off[j] = run;
            choff[j] = crun;
            run += cnt[j];
            crun += (cnt[j] + CHUNK - 1) / CHUNK;
        }
        off[S + 1] = run;
        choff[S + 1] = crun;
        chst[crun] = (unsigned short)run;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1;
    for (int j = warp; j <= S; j += NW) {
        int at = off[j];
        for (int base = 0; base < L; base += 32) {
            const int l = base + lane;
            const unsigned m = l < L ? contributions(pw[l], mf[l], j, S) : 0;
            const unsigned b0 = __ballot_sync(FULL, m & 1);
            const unsigned b1 = __ballot_sync(FULL, m & 2);
            const unsigned b2 = __ballot_sync(FULL, m & 4);
            int r = at + __popc(b0 & below) + __popc(b1 & below)
                + __popc(b2 & below);
            if (m & 1) ent[r++] = (unsigned short)(4 * l);
            if (m & 2) ent[r++] = (unsigned short)(4 * l + 1);
            if (m & 4) ent[r] = (unsigned short)(4 * l + 2);
            at += __popc(b0) + __popc(b1) + __popc(b2);
        }
        for (int q = choff[j] + lane; q < choff[j + 1]; q += 32)
            chst[q] = (unsigned short)(off[j] + (q - choff[j]) * CHUNK);
    }

    const int nch_max = bwd_chunks(L, S);
    const size_t tstride = (size_t)B * S;
    float prev = 0.f;
    int slot = 0;           // ring slot of the chain's current vector
    clk.start();
    for (int s0 = 0; s0 < T; s0 += K) {
        const int n = min(K, T - s0);
        const int slot0 = slot;
        const float* rows = lps + ((s0 / K) & 1) * K * S;
        // this batch's lp rows have landed (and the last batch's passes
        // are done); its lattice rows and the next batch's lp rows start,
        // to land while the chain runs
        cp_async_wait_all();
        __syncthreads();
        copy_lattice<NT>(fcs, lattice, s0, n, T, B, L, b, wide);
        if (s0 + K < T)
            copy_rows<NT>(lps + (((s0 / K) & 1) ^ 1) * K * S, lp, s0 + K,
                          min(K, T - s0 - K), T, B, S, b);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        clk.lap(0);

        // the chain
        for (int k = 0; k < n; ++k) {
            const int next = slot + 1 == R ? 0 : slot + 1;
            const float* cur = ring + (size_t)slot * L;
            float* nxt = ring + (size_t)next * L;
            const float* row = rows + k * S;
            float mn = NEG;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int l = tid + p * NT;
                if (l >= L) continue;
                const unsigned w = pw[l];
                float nw = NEG;
                if (w & OK_BIT) {
                    const float bn = cur[l] - prev;
                    const float stay = stay_score(row, w, S);
                    float mpart = NEG;
                    if (w & MOK_BIT)
                        mpart = move_score(row, w, mf + l, S)
                            + (cur[l + 1] - prev);
                    nw = logaddexpf_(stay + bn, mpart);
                }
                nxt[l] = nw;
                mn = fmaxf(mn, nw);
            }
            mn = warp_max(mn);
            if (lane == 0) red_c[(k & 1) * NW + warp] = mn;
            clk.lap(1);
            __syncthreads();
            float f = red_c[(k & 1) * NW];
#pragma unroll
            for (int w = 1; w < NW; ++w) f = fmaxf(f, red_c[(k & 1) * NW + w]);
            prev = f;
            if (tid == 0) prevs[next] = f;
            slot = next;
            clk.lap(2);
        }
        cp_async_wait_all();
        __syncthreads();
        clk.lap(3);

        // pass A: each position's stay and move terms, (fc + bwd) + score in
        // the twin's order (cat_mod moves reach tens of nats, and another
        // order rounds the posteriors of the weighted mod columns apart),
        // the stay term in place of its lattice value, the move term in a
        // register; each step's largest term
        float tmv[KR][P];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
            if (k >= n) continue;
            const int sk = slot0 + k < R ? slot0 + k : slot0 + k - R;
            const float* cur = ring + (size_t)sk * L;
            const float pv = prevs[sk];
            const float* row = rows + k * S;
            float* fcr = fcs + k * L;
            float mt = NEG;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int l = tid + p * NT;
                tmv[k][p] = NEG;
                if (l >= L) continue;
                const unsigned w = pw[l];
                float ts = NEG;
                if (w & OK_BIT) {
                    const float fc = fcr[l];
                    ts = fc + (cur[l] - pv) + stay_score(row, w, S);
                    if (w & MOK_BIT)
                        tmv[k][p] = fc + (cur[l + 1] - pv)
                            + move_score(row, w, mf + l, S);
                }
                fcr[l] = ts;
                mt = fmaxf(mt, fmaxf(ts, tmv[k][p]));
            }
            mt = warp_max(mt);
            if (lane == 0) red_a[k * NW + warp] = mt;
        }
        __syncthreads();
        clk.lap(4);

        // every read of the batch's vectors is done: each position's
        // exponentials, the stay one in place, the move one into the
        // position's entry of its step's vector (only this thread reads
        // either from here on)
#pragma unroll
        for (int k = 0; k < KR; ++k) {
            if (k >= n) continue;
            const int sk = slot0 + k < R ? slot0 + k : slot0 + k - R;
            float tmax = red_a[k * NW];
#pragma unroll
            for (int w = 1; w < NW; ++w) tmax = fmaxf(tmax, red_a[k * NW + w]);
            float* es = fcs + k * L;
            float* em = ring + (size_t)sk * L;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int l = tid + p * NT;
                if (l >= L) continue;
                const float ts = es[l], tm = tmv[k][p];
                es[l] = ts > 0.5f * NEG ? expf(ts - tmax) : 0.f;
                em[l] = tm > 0.5f * NEG ? expf(tm - tmax) : 0.f;
            }
        }
        __syncthreads();
        clk.lap(5);

        // pass B: every (step, chunk): the stay and move exponentials and
        // the weighted mod ones, summed apart in the chunk's order
        const int nch = choff[S + 1];
        for (int task = tid; task < n * nch; task += NT) {
            const int k = task / nch, q = task - k * nch;
            const float* es = fcs + k * L;
            const float* em = ring
                + (size_t)(slot0 + k < R ? slot0 + k : slot0 + k - R) * L;
            float a = 0.f, c = 0.f;
            const int e1 = chst[q + 1];
#pragma unroll 4
            for (int e = chst[q]; e < e1; ++e) {
                const int l = ent[e] >> 2, kind = ent[e] & 3;
                const float v = kind == 0 ? es[l] : em[l];
                const bool mod = kind == 2;
                a += mod ? 0.f : v;
                c += mod ? mf[l] * v : 0.f;
            }
            parts[k * nch_max + q] = make_float2(a, c);
        }
        __syncthreads();
        clk.lap(6);

        // the batch's rows of d lp: one warp a step
        for (int k = warp; k < n; k += NW) {
            const float2* pk = parts + k * nch_max;
            float den = 0.f;
            for (int q = lane; q < nch; q += 32) den += pk[q].x;
            den = warp_sum(den);
            // a row with no path gets all-zero posteriors
            den = den > 0.f ? den : 1.f;
            float* g = grad + (size_t)(T - 1 - s0 - k) * tstride
                + (size_t)b * S;
            for (int j = lane; j < S; j += 32) {
                float sum = 0.f;
                for (int q = choff[j]; q < choff[j + 1]; ++q)
                    sum += pk[q].x + pk[q].y;
                g[j] = sum / den;
            }
        }
        clk.lap(7);
    }
    if (CLOCK && threadIdx.x == 0) clk.store(cyc, blockIdx.x);
}

template <int NT, int P, bool CLOCK>
int launch_bwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const float* lattice,
               const int* valid, const int* last, float* grad, int T, int B,
               int S, int L, int K, long long* cyc, cudaStream_t st)
{
    const size_t smem = BwdLayout(L, S, K, NT / 32).bytes;
    if (smem > BWD_SMEM_MAX || K > bwd_batch_max(P))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        crf_bwd_kernel<NT, P, CLOCK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    crf_bwd_kernel<NT, P, CLOCK><<<B, NT, smem, st>>>(
        lp, sidx, midx, mmidx, mfact, lattice, valid, last, grad, T, B, S, L,
        K, cyc);
    return static_cast<int>(cudaGetLastError());
}

int bwd_threads(int L) { return L <= 2048 ? 256 : 512; }

// the steps a batch: at most BWD_BATCH and the registers' KR (by the
// positions a thread), fewer where the ring would not fit the block's
// shared memory (two blocks an SM up to 2048 positions, one past that)
int bwd_batch(int T, int S, int L)
{
    const int NT = bwd_threads(L), NW = NT / 32, P = (L + NT - 1) / NT;
    const size_t budget = L <= 2048 ? BWD_SMEM_SHARED : BWD_SMEM_MAX;
    int k = bwd_batch_max(P < 2 ? 1 : P <= 2 ? 2 : P <= 4 ? 4 : P <= 8 ? 8
                          : 16);
    if (T < k) k = T > 1 ? T : 1;
    while (k > 1 && BwdLayout(L, S, k, NW).bytes > budget) --k;
    return k;
}

// ---- kernels 9-10: the CRF on selected score streams -----------------------
//
// Kernel 9 is the chain above on a StreamReader, forward.  Kernel 10 is two
// launches (three for the route's d lp): (a) the chain above, backward,
// which writes each step's renormalised backward vector into the backward
// lattice [T, B, L] (scratch), and (b) the posterior pass, which has no
// serial chain: one CTA an item (t, b) at a time, over every item (a
// persistent grid), reads the item's forward and backward lattice rows and
// stream rows and forms its terms (fc + bwd) + score in the twin's order,
// their exact max, the exponentials and their sum in a fixed order (no
// float atomics), then either writes the posteriors (`post`: post_stay,
// post_move) or sums them into the S columns of d lp (`grad`: each
// column's contributions through the row's column lists, built once a row
// by crf_lists_kernel as kernel 6 builds its own and staged in shared
// memory where they fit, each CTA taking a row's steps in turn, cut into
// chunks of STREAM_CHUNK entries, each summed in order by one thread, then
// each column's chunks in order; the weighted mod column gets mfact x the
// move posterior).  So the route's d lp is bitwise the same from run to
// run, and no scatter runs.
//
// Bound: bytes.  Each step reads the stay and move rows (forward and
// backward) and the two lattices (the pass), writes the lattices and the
// outputs; the chains' arithmetic per position and step is one logaddexp,
// the pass's two exponentials.  probes/streams.py measured (PERF.md): at
// T=800, B=256, L=512 the chains move their streams and lattice at ~2 TB/s
// (its phase clock puts a third of a step in the wait for its scores, the
// same with rings of 2 to 8 steps), and the pass is held by its terms'
// loads.  The pass keeps an item's exponentials in shared memory (8L
// bytes) where they fit, else in a per-CTA scratch in device memory
// (L2-resident).
//
// Bands by L (TT_STREAM_BANDS): kernel 5's up to 8192, then clusters of 4
// (to 16384) and 8 CTAs (to MAX_L_CLUSTER = 32768 positions: 1024 threads
// x 4 positions x 8).  Past that the chains keep each row's [2][L] vector
// in device memory (crf_chain_gmem_kernel: a caller-allocated scratch of
// [B, 2, L] floats, double-buffered, one CTA of 1024 threads a row walking
// its positions l = tid, tid + 1024, ... and reading its scores at the
// step; __syncthreads orders the device-memory reads of one step before
// the writes of the next), so any L runs; each position's arithmetic is
// the cluster instances'.

constexpr int MAX_L_CLUSTER = 32768;
constexpr int GMEM_NT = 1024;
constexpr size_t POST_SMEM_MAX = 200 * 1024;     // one CTA an SM
constexpr size_t POST_SMEM_SHARED = 112 * 1024;  // two CTAs an SM

// Block max of v over NT threads through red[NT / 32] (one barrier).
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

template <int NT, bool BWD>
__global__ void __launch_bounds__(NT)
crf_chain_gmem_kernel(const float* __restrict__ stay,
                      const float* __restrict__ move,
                      const int* __restrict__ valid,
                      const int* __restrict__ lastpos,
                      float* __restrict__ fwd_final,
                      float* __restrict__ score_out,
                      float* __restrict__ lattice, float* gstate, int T,
                      int B, int L)
{
    constexpr int NW = NT / 32;
    __shared__ float red[2 * NW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    const int last = BWD ? lastpos[blockIdx.x] : 0;
    float* state = gstate + 2 * row;           // [2][L], unrenormalised

    for (int l = tid; l < L; l += NT)
        state[l] = (l == last && valid[row + l] != 0) ? 0.f : NEG;
    __syncthreads();

    float prev = 0.f, score = 0.f;
    for (int s = 0; s < T; ++s) {
        const float* cur = state + (s & 1) * L;
        float* nxt = state + ((s + 1) & 1) * L;
        const size_t off = (size_t)(BWD ? T - 1 - s : s) * tstride + row;
        float m = NEG;
        for (int l = tid; l < L; l += NT) {
            const bool ok = valid[row + l] != 0;
            const float f = ok ? cur[l] - prev : NEG;
            if (lattice != nullptr) lattice[off + l] = f;
            float nw = NEG;
            if (ok) {
                if (BWD) {
                    const float mpart = l < last
                        ? move[off + l] + (cur[l + 1] - prev) : NEG;
                    nw = logaddexpf_(stay[off + l] + f, mpart);
                } else {
                    const float mpart = l > 0
                        ? (cur[l - 1] - prev) + move[off + l - 1] : NEG;
                    nw = logaddexpf_(f + stay[off + l], mpart);
                }
            }
            nxt[l] = nw;
            m = fmaxf(m, nw);
        }
        prev = block_max<NT>(m, red + (s & 1) * NW, lane, warp);
        score += prev;
    }
    if (BWD) return;
    const float* fin = state + (T & 1) * L;
    for (int l = tid; l < L; l += NT)
        fwd_final[row + l] = valid[row + l] != 0 ? fin[l] - prev : NEG;
    if (tid == 0) score_out[blockIdx.x] = score;
}

// column index in [0, S], S for one outside [0, S) (it selects nothing);
// any S
__device__ __forceinline__ int colw(int idx, int S)
{
    return (unsigned)idx < (unsigned)S ? idx : S;
}

// entries of a chunk of the stream lists, summed by one thread
constexpr int STREAM_CHUNK = 16;

// chunks of a row's column lists at most
__host__ __device__ inline int list_chunks(int L, int S)
{
    return (3 * L + STREAM_CHUNK - 1) / STREAM_CHUNK + S + 1;
}

// ints of a row's column lists: choff [S + 2] (each column's first chunk),
// chst [chunks + 1] (each chunk's first entry, then the count), ent [3L]
// (4 x position + kind: 0 the stay, 1 the move, 2 the weighted mod)
__host__ __device__ inline size_t list_ints(int L, int S)
{
    return (size_t)S + 2 + list_chunks(L, S) + 1 + 3 * (size_t)L;
}

// which of position l's contributions (bit 0 stay, 1 move, 2 weighted mod)
// go to column j of d lp; column S collects stays and moves whose index
// selects nothing (they count in the denominator only)
__device__ __forceinline__ unsigned stream_contrib(
    const int* sidx, const int* midx, const int* mmidx, const float* mfact,
    const int* valid, size_t at, int l, int last, int j, int S)
{
    if (valid[at] == 0) return 0;
    unsigned m = colw(sidx[at], S) == j ? 1u : 0u;
    if (l < last) {
        if (colw(midx[at], S) == j) m |= 2;
        if (j < S && mfact[at] != 0.f && colw(mmidx[at], S) == j) m |= 4;
    }
    return m;
}

// The column lists of row b (one CTA a row): a stable counting sort of the
// row's contributions by column, then position, then kind; warp w counts
// and then fills columns w, w + NW, ...  Dynamic shared memory: cnt
// [S + 1], off [S + 2].
template <int NT>
__global__ void __launch_bounds__(NT)
crf_lists_kernel(const int* __restrict__ sidx, const int* __restrict__ midx,
                 const int* __restrict__ mmidx,
                 const float* __restrict__ mfact,
                 const int* __restrict__ valid,
                 const int* __restrict__ lastpos, int* __restrict__ lists,
                 int L, int S)
{
    constexpr int NW = NT / 32;
    extern __shared__ int lsm[];
    int* cnt = lsm;
    int* off = lsm + S + 1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x, last = lastpos[b];
    const size_t rowoff = (size_t)b * L;
    int* choff = lists + (size_t)b * list_ints(L, S);
    int* chst = choff + S + 2;
    int* ent = chst + list_chunks(L, S) + 1;
    auto contrib = [&](int l, int j) {
        return l < L ? stream_contrib(sidx, midx, mmidx, mfact, valid,
                                      rowoff + l, l, last, j, S)
                     : 0u;
    };
    for (int j = warp; j <= S; j += NW) {
        int n = 0;
        for (int base = 0; base < L; base += 32)
            n += __reduce_add_sync(FULL, __popc(contrib(base + lane, j)));
        if (lane == 0) cnt[j] = n;
    }
    __syncthreads();
    if (tid == 0) {
        int run = 0, crun = 0;
        for (int j = 0; j <= S; ++j) {
            off[j] = run;
            choff[j] = crun;
            run += cnt[j];
            crun += (cnt[j] + STREAM_CHUNK - 1) / STREAM_CHUNK;
        }
        off[S + 1] = run;
        choff[S + 1] = crun;
        chst[crun] = run;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1;
    for (int j = warp; j <= S; j += NW) {
        int at = off[j];
        for (int base = 0; base < L; base += 32) {
            const int l = base + lane;
            const unsigned m = contrib(l, j);
            const unsigned b0 = __ballot_sync(FULL, m & 1);
            const unsigned b1 = __ballot_sync(FULL, m & 2);
            const unsigned b2 = __ballot_sync(FULL, m & 4);
            int r = at + __popc(b0 & below) + __popc(b1 & below)
                + __popc(b2 & below);
            if (m & 1) ent[r++] = 4 * l;
            if (m & 2) ent[r++] = 4 * l + 1;
            if (m & 4) ent[r] = 4 * l + 2;
            at += __popc(b0) + __popc(b1) + __popc(b2);
        }
        for (int q = choff[j] + lane; q < choff[j + 1]; q += 32)
            chst[q] = off[j] + (q - choff[j]) * STREAM_CHUNK;
    }
}

// The posterior pass's shared memory, in floats: the reductions [2][32];
// the exponentials es, em [L] each where they fit (ex); then (GRAD) the
// chunk sums [chunks] float2, and where they fit (lists) a copy of the
// item's row's column lists and its mod weights [L].
struct PostLayout {
    size_t ex, parts, lists, mf, floats;
    __host__ __device__ PostLayout(int L, int S, bool grad, bool in_ex,
                                   bool in_lists)
    {
        size_t o = 64;
        ex = o;
        o += in_ex ? 2 * (size_t)L : 0;
        parts = o;
        o += grad ? 2 * (size_t)list_chunks(L, S) : 0;
        lists = o;
        o += grad && in_lists ? list_ints(L, S) : 0;
        mf = o;
        o += grad && in_lists ? (size_t)L : 0;
        floats = o;
    }
};

// the exponentials in shared memory where they fit; the lists too where,
// beside them, they leave two CTAs an SM
inline bool post_in_smem(int L, int S, bool grad)
{
    return sizeof(float) * PostLayout(L, S, grad, true, false).floats
        <= POST_SMEM_MAX;
}

inline bool lists_in_smem(int L, int S)
{
    return sizeof(float) * PostLayout(L, S, true, true, true).floats
        <= POST_SMEM_SHARED;
}

template <int NT, bool GRAD, bool CLOCK>
__global__ void __launch_bounds__(NT)
crf_post_kernel(const float* __restrict__ stay,
                const float* __restrict__ move,
                const float* __restrict__ lattice,
                const float* __restrict__ blat,
                const int* __restrict__ valid,
                const int* __restrict__ lastpos,
                const float* __restrict__ mfact,
                const int* __restrict__ lists, float* __restrict__ out0,
                float* __restrict__ out1, float* gex, int T, int B, int L,
                int S, int stage, long long* __restrict__ cyc)
{
    constexpr int NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    const PostLayout lay(L, S, GRAD, gex == nullptr, stage != 0);
    float* red = smem;                         // [2][32] maxima, sums
    float* es = gex != nullptr ? gex + (size_t)blockIdx.x * 2 * L
                               : smem + lay.ex;
    float* em = es + L;
    float2* parts = reinterpret_cast<float2*>(smem + lay.parts);
    int* slists = reinterpret_cast<int*>(smem + lay.lists);
    float* smf = smem + lay.mf;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // this CTA's items, consecutive in (b, t) order: a row's column lists
    // are staged once for all its steps
    const size_t items = (size_t)T * B;
    const size_t per = (items + gridDim.x - 1) / gridDim.x;
    const size_t i0 = (size_t)blockIdx.x * per;
    const size_t i1 = i0 + per < items ? i0 + per : items;
    const size_t nli = list_ints(L, S);
    const int* choff = nullptr;
    const float* mf = nullptr;
    int cur = -1;
    // the phase clock (probes/streams.py): terms, exponentials, epilogue
    PhaseClock<CLOCK, 3> clk;
    clk.start();
    for (size_t item = i0; item < i1; ++item) {
        const int b = (int)(item / T), t = (int)(item - (size_t)b * T);
        const size_t rowoff = (size_t)b * L;
        const size_t base = ((size_t)t * B + b) * L;
        const int last = lastpos[b];
        if (GRAD && b != cur) {
            cur = b;
            choff = lists + (size_t)b * nli;
            mf = mfact + rowoff;
            if (stage) {
                // every read of the last row's copy is done (the item's
                // closing barrier)
                for (size_t i = tid; i < nli; i += NT) slists[i] = choff[i];
                for (int l = tid; l < L; l += NT) smf[l] = mf[l];
                __syncthreads();
                choff = slists;
                mf = smf;
            }
        }
        float mt = NEG;
        for (int l = tid; l < L; l += NT) {
            float ts = NEG, tm = NEG;
            if (valid[rowoff + l] != 0) {
                const float fc = lattice[base + l];
                ts = fc + blat[base + l] + stay[base + l];
                if (l < last) tm = fc + blat[base + l + 1] + move[base + l];
            }
            es[l] = ts;
            em[l] = tm;
            mt = fmaxf(mt, fmaxf(ts, tm));
        }
        mt = warp_max_redux(mt);
        if (lane == 0) red[warp] = mt;
        __syncthreads();
        const float tmax = warp_max_redux(lane < NW ? red[lane] : NEG);
        clk.lap(0);
        float part = 0.f;
        for (int l = tid; l < L; l += NT) {
            const float ts = es[l], tm = em[l];
            const float xs = ts > 0.5f * NEG ? expf(ts - tmax) : 0.f;
            const float xm = tm > 0.5f * NEG ? expf(tm - tmax) : 0.f;
            es[l] = xs;
            em[l] = xm;
            part += xs + xm;
        }
        part = warp_sum(part);
        if (lane == 0) red[32 + warp] = part;
        __syncthreads();
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) den += red[32 + w];
        // a row with no path gets all-zero posteriors (pallas_crf.py:197)
        den = den > 0.f ? den : 1.f;
        clk.lap(1);
        if (!GRAD) {
            for (int l = tid; l < L; l += NT) {
                out0[base + l] = es[l] / den;
                out1[base + l] = em[l] / den;
            }
        } else {
            const int* chst = choff + S + 2;
            const int* ent = chst + list_chunks(L, S) + 1;
            const int nch = choff[S + 1];
            // a thread a chunk, its entries summed in list order
            for (int q = tid; q < nch; q += NT) {
                const int e0 = chst[q], n = chst[q + 1] - e0;
                float a = 0.f, c = 0.f;
#pragma unroll
                for (int i = 0; i < STREAM_CHUNK; ++i) {
                    if (i < n) {
                        const int x = ent[e0 + i], l = x >> 2;
                        if ((x & 3) == 0)
                            a += es[l];
                        else if ((x & 3) == 1)
                            a += em[l];
                        else
                            c += mf[l] * em[l];
                    }
                }
                parts[q] = make_float2(a, c);
            }
            __syncthreads();
            float* g = out0 + ((size_t)t * B + b) * S;
            for (int j = tid; j < S; j += NT) {
                float sum = 0.f;
                for (int q = choff[j]; q < choff[j + 1]; ++q)
                    sum += parts[q].x + parts[q].y;
                g[j] = sum / den;
            }
        }
        clk.lap(2);
        // the item's exponentials, chunk sums and reductions are free
        __syncthreads();
    }
    if (CLOCK && tid == 0) clk.store(cyc, blockIdx.x);
}

int card_sms()
{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

int post_threads(int L) { return L <= 2048 ? 256 : L <= 8192 ? 512 : 1024; }

// The scratch of kernel 10's entries, in floats: the backward lattice [T,
// B, L]; past MAX_L_CLUSTER the chains' [B, 2, L] vectors; where an
// item's exponentials do not fit the pass's shared memory, [sms][2][L];
// and (grad) the rows' column lists [B][list_ints].
struct StreamScratch {
    size_t blat, gstate, gex, lists, floats;
    StreamScratch(int T, int B, int L, int S, bool grad)
    {
        size_t o = 0;
        blat = o;
        o += (size_t)T * B * L;
        gstate = o;
        o += L > MAX_L_CLUSTER ? 2 * (size_t)B * L : 0;
        gex = o;
        o += post_in_smem(L, S, grad) ? 0 : 2 * (size_t)card_sms() * L;
        lists = o;
        o += grad ? (size_t)B * list_ints(L, S) : 0;
        floats = o;
    }
};

// the posterior pass over every item (t, b): persistent, as many CTAs as
// fit the card (one an SM where the exponentials live in device memory,
// gex)
template <int NT, bool GRAD, bool CLOCK>
int launch_post(const float* stay, const float* move, const float* lattice,
                const float* blat, const int* valid, const int* last,
                const float* mfact, const int* lists, float* out0,
                float* out1, float* gex, int T, int B, int L, int S,
                long long* cyc, cudaStream_t st)
{
    auto kernel = crf_post_kernel<NT, GRAD, CLOCK>;
    const bool stage = GRAD && gex == nullptr && lists_in_smem(L, S);
    const size_t smem = sizeof(float)
        * PostLayout(L, S, GRAD, gex == nullptr, stage).floats;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int per_sm = 1;
    if (gex == nullptr) {
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, NT, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        per_sm = per_sm < 1 ? 1 : per_sm;
    }
    const size_t items = (size_t)T * B;
    const size_t grid = std::min(items, (size_t)card_sms() * per_sm);
    kernel<<<(unsigned)grid, NT, smem, st>>>(stay, move, lattice, blat,
                                             valid, last, mfact, lists, out0,
                                             out1, gex, T, B, L, S,
                                             stage ? 1 : 0, cyc);
    return static_cast<int>(cudaGetLastError());
}

template <bool GRAD, bool CLOCK>
int post_dispatch(const float* stay, const float* move, const float* lattice,
                  const float* blat, const int* valid, const int* last,
                  const float* mfact, const int* lists, float* out0,
                  float* out1, float* gex, int T, int B, int L, int S,
                  long long* cyc, cudaStream_t st)
{
#define TT_POST(NT) launch_post<NT, GRAD, CLOCK>(                        \
        stay, move, lattice, blat, valid, last, mfact, lists, out0, out1, \
        gex, T, B, L, S, cyc, st)
    switch (post_threads(L)) {
    case 256: return TT_POST(256);
    case 512: return TT_POST(512);
    default: return TT_POST(1024);
    }
#undef TT_POST
}

// the steps a batch of a stream chain on ntb threads a block (its ring
// two batches): at most STREAM_BATCH_MAX, the ring at most 96 KB (two CTAs
// an SM) up to 512 threads, 200 KB past that (one CTA an SM)
int stream_ring(int ntb, int P)
{
    const size_t slot = sizeof(float) * stream_slot_floats(ntb, P);
    const size_t budget = (ntb <= 512 ? 96 : 200) * 1024;
    const int k = (int)(budget / (2 * slot));
    return k < 1 ? 1 : k > STREAM_BATCH_MAX ? STREAM_BATCH_MAX : k;
}

}  // namespace

// tt_crf_bwd with K steps a batch (K <= 0: bwd_batch's); with CLOCK, the
// phase clock's cycles into cyc [B][BWD_PHASES]
template <bool CLOCK>
int crf_bwd_dispatch(const float* lp, const int* sidx, const int* midx,
                     const int* mmidx, const float* mfact,
                     const float* lattice, const int* valid, const int* last,
                     float* grad, int T, int B, int S, int L, int K,
                     long long* cyc, cudaStream_t st)
{
    if (B == 0 || T == 0) return 0;
    if (S > MAX_S || L == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (K <= 0) K = bwd_batch(T, S, L);
#define TT_BWD(NT, P) launch_bwd<NT, P, CLOCK>(                          \
        lp, sidx, midx, mmidx, mfact, lattice, valid, last, grad, T, B, S, \
        L, K, cyc, st)
    if (L <= 256) return TT_BWD(256, 1);
    if (L <= 512) return TT_BWD(256, 2);
    if (L <= 1024) return TT_BWD(256, 4);
    if (L <= 2048) return TT_BWD(256, 8);
    if (L <= 4096) return TT_BWD(512, 8);
    if (L <= 8192) return TT_BWD(512, 16);
    return static_cast<int>(cudaErrorInvalidValue);
#undef TT_BWD
}

// The forward's instance by lattice width: (at most MAXNT threads a row,
// P positions a thread, CL CTAs a row), as probes/forward.py measured them
// on the card: one warp a row (no barrier) up to 64 positions, 2 a thread
// up to 2048, 4 up to 4096, and past that a cluster of two CTAs.
#define TT_FWD_BANDS(CALL)                                      \
    if (L <= 64) return CALL(32, 2, 1);                         \
    if (L <= 1024) return CALL(512, 2, 1);                      \
    if (L <= 2048) return CALL(1024, 2, 1);                     \
    if (L <= 4096) return CALL(1024, 4, 1);                     \
    if (L <= MAX_L) return CALL(1024, 4, 2);                    \
    return static_cast<int>(cudaErrorInvalidValue);

// tt_crf_fwd with K steps of lp rows a batch (K <= 0: FWD_BATCH); with
// CLOCK, the phase clock's cycles into cyc [B][FWD_PHASES]
template <bool FAST, bool CLOCK>
int crf_fwd_dispatch(const float* lp, const int* sidx, const int* midx,
                     const int* mmidx, const float* mfact, const int* valid,
                     float* fwd_final, float* score, float* lattice, int T,
                     int B, int S, int L, int K, long long* cyc,
                     cudaStream_t st)
{
    if (B == 0 || L == 0) return 0;
    if (S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
    if (K <= 0) K = FWD_BATCH;
#define TT_FWD(NT, P, CL) launch_fwd<NT, P, CL, FAST, CLOCK>(           \
        lp, sidx, midx, mmidx, mfact, valid, fwd_final, score, lattice, T, \
        B, S, L, K, fwd_threads<NT, P, CL>(L), cyc, st)
    TT_FWD_BANDS(TT_FWD)
#undef TT_FWD
}

// The stream chains' instance by lattice width: kernel 5's bands
// (TT_FWD_BANDS) up to 8192 positions, then clusters of 4 and 8 CTAs (one
// CTA of 1024 threads x 4 positions a cluster rank) to MAX_L_CLUSTER.
#define TT_STREAM_BANDS(CALL)                                   \
    if (L <= MAX_L) { TT_FWD_BANDS(CALL) }                      \
    if (L <= 2 * MAX_L) return CALL(1024, 4, 4);                \
    if (L <= MAX_L_CLUSTER) return CALL(1024, 4, 8);            \
    return static_cast<int>(cudaErrorInvalidValue);

// a stream chain in layout (MAXNT, P, CL) at ring depth K (<= 0:
// stream_ring's); with CLOCK, cycles into cyc [B][FWD_PHASES]
template <int MAXNT, int P, int CL, bool BWD, bool CLOCK>
int stream_chain_at(const float* stay, const float* move, const int* valid,
                    const int* last, float* fwd_final, float* score,
                    float* lattice, int T, int B, int L, int K,
                    long long* cyc, cudaStream_t st)
{
    const int NT = fwd_threads<MAXNT, P, CL>(L);
    if (K <= 0) K = stream_ring(NT == 32 ? 32 * FWD_WARP_ROWS : NT, P);
    return launch_chain<MAXNT, P, CL, false, CLOCK, BWD,
                        StreamReader<P, BWD>>(
        StreamSource{stay, move}, valid, last, fwd_final, score, lattice, T,
        B, L, K, NT, 0, cyc, st);
}

// kernel 9 (forward) or kernel 10's chain (BWD: the backward lattice into
// `lattice`) in its band; past MAX_L_CLUSTER the device-memory instance on
// gstate [B, 2, L]
template <bool BWD, bool CLOCK>
int stream_chain(const float* stay, const float* move, const int* valid,
                 const int* last, float* fwd_final, float* score,
                 float* lattice, float* gstate, int T, int B, int L, int K,
                 long long* cyc, cudaStream_t st)
{
    if (L > MAX_L_CLUSTER) {
        if (gstate == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
        crf_chain_gmem_kernel<GMEM_NT, BWD><<<B, GMEM_NT, 0, st>>>(
            stay, move, valid, last, fwd_final, score, lattice, gstate, T, B,
            L);
        return static_cast<int>(cudaGetLastError());
    }
#define TT_CHAIN(MAXNT, P, CL) stream_chain_at<MAXNT, P, CL, BWD, CLOCK>( \
        stay, move, valid, last, fwd_final, score, lattice, T, B, L, K, cyc, \
        st)
    TT_STREAM_BANDS(TT_CHAIN)
#undef TT_CHAIN
}

// the column lists of every row (GRAD's pass reads them)
inline int launch_lists(const int* sidx, const int* midx, const int* mmidx,
                        const float* mfact, const int* valid,
                        const int* last, int* lists, int B, int L, int S,
                        cudaStream_t st)
{
    constexpr int NT = 512;
    const size_t smem = sizeof(int) * (2 * (size_t)S + 3);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_lists_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_lists_kernel<NT><<<B, NT, smem, st>>>(sidx, midx, mmidx, mfact,
                                              valid, last, lists, L, S);
    return static_cast<int>(cudaGetLastError());
}

// kernel 10: the backward chain into the scratch's backward lattice, then
// (GRAD) the column lists and the pass into d lp out0 [T, B, S], or the
// pass into the posteriors out0, out1 [T, B, L]
template <bool GRAD>
int bwd_streams(const float* stay, const float* move, const float* lattice,
                const int* valid, const int* last, const int* sidx,
                const int* midx, const int* mmidx, const float* mfact,
                float* out0, float* out1, float* scratch, int T, int B,
                int L, int S, cudaStream_t st)
{
    if (B == 0 || T == 0 || L == 0 || (GRAD && S == 0)) return 0;
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const StreamScratch sc(T, B, L, S, GRAD);
    float* blat = scratch + sc.blat;
    int e = stream_chain<true, false>(stay, move, valid, last, nullptr,
                                      nullptr, blat, scratch + sc.gstate, T,
                                      B, L, 0, nullptr, st);
    if (e) return e;
    int* lists = GRAD ? reinterpret_cast<int*>(scratch + sc.lists) : nullptr;
    if (GRAD) {
        e = launch_lists(sidx, midx, mmidx, mfact, valid, last, lists, B, L,
                         S, st);
        if (e) return e;
    }
    float* gex = post_in_smem(L, S, GRAD) ? nullptr : scratch + sc.gex;
    return post_dispatch<GRAD, false>(stay, move, lattice, blat, valid, last,
                                      mfact, lists, out0, out1, gex, T, B, L,
                                      S, nullptr, st);
}

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
    return crf_fwd_dispatch<false, false>(
        lp, sidx, midx, mmidx, mfact, valid, fwd_final, score, lattice, T,
        B, S, L, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// the layout tt_crf_fwd takes at lattice width L, packed: threads a row
// << 16 | positions a thread << 8 | CTAs a row; 0 outside 1 .. MAX_L
int tt_crf_fwd_layout(int L)
{
    if (L < 1 || L > MAX_L) return 0;
#define TT_LAYOUT(NT, P, CL) \
    (fwd_threads<NT, P, CL>(L) << 16 | (P) << 8 | (CL))
    TT_FWD_BANDS(TT_LAYOUT)
#undef TT_LAYOUT
}

// ... + lattice [T, B, L] of tt_crf_fwd, last [B] int32 -> grad [T, B, S].
int tt_crf_bwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const float* lattice,
               const int* valid, const int* last, float* grad, int T, int B,
               int S, int L, void* stream)
{
    return crf_bwd_dispatch<false>(lp, sidx, midx, mmidx, mfact, lattice,
                                   valid, last, grad, T, B, S, L, 0, nullptr,
                                   static_cast<cudaStream_t>(stream));
}

// the steps a batch of tt_crf_bwd at this shape
int tt_crf_bwd_batch(int T, int B, int S, int L)
{
    (void)B;
    return bwd_batch(T, S, L);
}

// stay, move [T, B, L]; valid [B, L] int32 -> fwd_final [B, L], score [B]
// (the summed renormalisers), lattice [T, B, L] (may be null).  Past
// MAX_L_CLUSTER positions the vector lives in gstate [B, 2, L] (scratch;
// may be null below).
int tt_crf_fwd_streams(const float* stay, const float* move,
                       const int* valid, float* fwd_final, float* score,
                       float* lattice, float* gstate, int T, int B, int L,
                       void* stream)
{
    if (B == 0 || L == 0) return 0;
    return stream_chain<false, false>(stay, move, valid, nullptr, fwd_final,
                                      score, lattice, gstate, T, B, L, 0,
                                      nullptr,
                                      static_cast<cudaStream_t>(stream));
}

// the layout of the stream chains at lattice width L, packed as
// tt_crf_fwd_layout's; 0 outside 1 .. MAX_L_CLUSTER (past it the
// device-memory instance)
int tt_crf_streams_layout(int L)
{
    if (L < 1 || L > MAX_L_CLUSTER) return 0;
#define TT_LAYOUT(NT, P, CL) \
    (fwd_threads<NT, P, CL>(L) << 16 | (P) << 8 | (CL))
    TT_STREAM_BANDS(TT_LAYOUT)
#undef TT_LAYOUT
}

// the floats of the scratch that tt_crf_bwd_posteriors (grad = 0) and
// tt_crf_grad_streams (grad = 1, S columns) take at this shape
long long tt_crf_streams_scratch(int T, int B, int L, int S, int grad)
{
    return (long long)StreamScratch(T, B, L, S, grad != 0).floats;
}

// ... + lattice [T, B, L] of tt_crf_fwd_streams, last [B] int32 ->
// post_stay, post_move [T, B, L]; scratch of tt_crf_streams_scratch's
// floats.
int tt_crf_bwd_posteriors(const float* stay, const float* move,
                          const float* lattice, const int* valid,
                          const int* last, float* post_stay,
                          float* post_move, float* scratch, int T, int B,
                          int L, void* stream)
{
    return bwd_streams<false>(stay, move, lattice, valid, last, nullptr,
                              nullptr, nullptr, nullptr, post_stay,
                              post_move, scratch, T, B, L, 0,
                              static_cast<cudaStream_t>(stream));
}

// ... + the route's columns: sidx, midx, mmidx [B, L] int32 (move column l
// the move l -> l+1; an index outside [0, S) selects nothing), mfact [B,
// L] -> grad [T, B, S], d score / d lp: the posteriors summed into their
// columns (the weighted mod column gets mfact x the move's).
int tt_crf_grad_streams(const float* stay, const float* move,
                        const float* lattice, const int* valid,
                        const int* last, const int* sidx, const int* midx,
                        const int* mmidx, const float* mfact, float* grad,
                        float* scratch, int T, int B, int L, int S,
                        void* stream)
{
    return bwd_streams<true>(stay, move, lattice, valid, last, sidx, midx,
                             mmidx, mfact, grad, nullptr, scratch, T, B, L,
                             S, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
