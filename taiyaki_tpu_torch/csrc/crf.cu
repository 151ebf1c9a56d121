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
// logaddexp at every position and a max over the row: see crf_fwd_kernel.
// The lattice it writes is the bytes bound (0.42 GB at T=800, B=256,
// L=512, ~0.13 ms of device memory time); the chain's arithmetic at every
// position (~50 instructions a position and step, issued on B rows' SMs)
// bounds it near ~0.2 ms there.
//
// The backward (kernel 6) runs the same kind of chain backwards, one
// barrier a step, and takes the posteriors off it: see crf_bwd_kernel.

// Kernels 9-10 (tt_crf_fwd_streams, tt_crf_bwd_posteriors) replace the
// unfused TPU kernels pallas_crf.py:108 `crf_forward` and pallas_crf.py:218
// `crf_backward_posteriors`: the same recursions on pre-selected f32 score
// streams stay [T, B, L] and move [T, B, L] (column l the move l -> l+1),
// which the caller gathers from lp (ops/flipflop.py).  The forward writes
// the lattice; the backward writes the posteriors post_stay and post_move
// [T, B, L] of each step's 2L-1 transitions, which the caller scatters into
// d lp.  Positions are masked by index (l == 0, valid[l], l < last), never
// by the padding value of a stream.
//
// Bound: bytes.  Each step reads two (forward) or three (backward) [L]
// rows and writes one or two, so the streams are 1.26 GB (forward) and
// 2.10 GB (backward) at T=800, B=256, L=512: 0.38 and 0.63 ms of device
// memory time, against a chain of a few microseconds a step.  The design
// keeps the chain short: one block per batch row with the [L] vector in
// shared memory (the shift by one position is a read of the neighbour's
// entry), coalesced loads (l = tid + p * NT), the next step's rows loaded
// into registers at the top of each step, before its stores and barriers,
// so their latency hides behind the step's work; one barrier a step
// forward (a block max), two backward (the max, then the posteriors' sum).
// L reaches 16384 (1024 threads x 16 positions; shared memory 2L floats
// plus a few dozen, 128 KB), twice the fused kernels' 8192, so every
// lattice those refuse has a route.  Above 2048 positions the blocks grow
// to 512 and 1024 threads, whose register budget (128, 64) makes the
// compiler spill the per-position registers of the largest cases: that
// costs time there, not correctness.
//
// Past 16384 positions (a chunk of over 80 000 samples at stride 5, which
// the JAX package trains on its unfused route) a second instance of each
// (crf_fwd_streams_gmem_kernel, crf_bwd_posteriors_gmem_kernel) keeps the
// row's [L] vector in device memory instead: a caller-allocated scratch of
// [B, 2, L] floats, double-buffered per row as the shared-memory one, 160
// KB a row at L = 20000, so it stays in the 50 MB L2.  Any L fits: each of
// 1024 threads walks positions l = tid, tid + 1024, ... in a loop and
// reads its scores at the step (no registers per position).  The same
// barriers order the reads of one step before the writes of the next
// (__syncthreads orders device memory within a block); the backward
// keeps no terms in registers, so it writes the unnormalised
// exponentials into the posterior outputs and divides them there once
// the step's sum is known.  Each position's arithmetic is the
// shared-memory instance's, in the same order.

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

// ---- kernel 5: the forward -----------------------------------------------
//
// Replaces pallas_crf.py:423 `crf_forward_fused`.  Per step t: new[l] =
// logaddexp(fwd[l] + stay[l], fwd[l-1] + move[l-1]) at every valid
// position, its max over the row (the step's factor, summed into the
// score), fwd = new - factor; lattice[t] is fwd before the step.
//
// Layout: CL CTAs of NT threads a row (CL = 2, a thread-block cluster, at
// the widest lattices), P consecutive positions a thread, l = (rank NT +
// tid) P + p; NT is the launch's, at most the instance's MAXNT, the
// fewest warps that hold L.  The state lives in registers,
// renormalised: position l - 1 is the same thread's, or the lane below's
// (__shfl_up_sync), and only a warp's first position needs the warp
// below's last value, which it reads from shared memory after the step's
// one barrier; that barrier also gives the block max (one redux a warp,
// one more over the warps' maxima).  With MAXNT = 32 a row is one warp
// and needs no barrier at all (FWD_WARP_ROWS rows a block); with CL = 2
// the barrier is the cluster's, the other CTA's maxima and boundary value
// read through distributed shared memory.  Each position's columns and
// flags are one packed word in a register (col8), its mod weight another.
//
// What bounds it is the positions' arithmetic, issued on the SMs of B
// rows: a logaddexp (accurate expf and log1pf, some 50 instructions) at
// every position and step.  probes/forward.py measured the layouts by L
// (PERF.md): 2 positions a thread beat 4 to 16 up to 2048 positions (more
// warps to hide the chain's latency), one warp a row lost to more warps
// with a barrier, and the cluster won only past 4096 positions, where one
// CTA would need 8 positions a thread and spill.
//
// No step waits on device memory: the lp rows of K steps (a batch) go by
// cp.async into a ring of two batches in shared memory, one batch ahead
// (16 bytes a copy where S is a multiple of 4 and lp 16-byte aligned, else
// 4), each row padded with a zero at column S, so a column outside [0, S)
// reads 0 without a compare.  The lattice rows go out as 16-byte stores
// where L is a multiple of 4, else 4-byte.
//
// Arithmetic as the plain twin's: the mod fold rounded as `mod_fold`, the
// logaddexp as `logaddexpf_`, the exact max of the step, impossible states
// NEG, so the lattice matches the twin to rounding.  (FAST, the probe's
// alone: __expf and __logf, which missed the lattice's 1e-4 by 5-20x.)

constexpr int FWD_WARP_ROWS = 4;   // rows a block where a row is one warp
constexpr int FWD_BATCH = 16;      // steps of lp rows a batch
// the phase clock's: lp wait, lattice stores, positions, barrier
constexpr int FWD_PHASES = 4;

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

// dynamic shared memory of the forward on NT threads a row: the rings,
// then the maxima and boundary values [2][NT / 32] each (none where a row
// is one warp)
inline size_t fwd_smem(int NT, int S, int K)
{
    const int rows = NT == 32 ? FWD_WARP_ROWS : 1;
    return sizeof(float) * ((size_t)rows * 2 * K * fwd_row_floats(S)
                            + (NT > 32 ? 4 * (NT / 32) : 0));
}

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

template <int MAXNT, int P, int CL, bool FAST, bool CLOCK>
__global__ void __launch_bounds__(MAXNT == 32 ? 32 * FWD_WARP_ROWS : MAXNT)
crf_fwd_kernel(const float* __restrict__ lp, const int* __restrict__ stay_idx,
               const int* __restrict__ move_idx,
               const int* __restrict__ mod_idx,
               const float* __restrict__ mod_fact,
               const int* __restrict__ valid, float* __restrict__ fwd_final,
               float* __restrict__ score_out, float* __restrict__ lattice,
               int T, int B, int S, int L, int K,
               long long* __restrict__ cyc)
{
    static_assert(MAXNT % 32 == 0 && (CL == 1 || MAXNT > 32), "layout");
    const int NT = MAXNT == 32 ? 32 : blockDim.x, NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int SP = fwd_row_floats(S);
    // the row, this CTA's rank in it, the thread in the row's CTA
    const int b = MAXNT == 32 ? blockIdx.x * FWD_WARP_ROWS + warp
                              : blockIdx.x / CL;
    const int rank = CL == 1 ? 0 : blockIdx.x % CL;
    const int rt = MAXNT == 32 ? lane : threadIdx.x;
    if (MAXNT == 32 && b >= B) return;  // a whole warp, which syncs alone
    float* ring = smem + (MAXNT == 32 ? warp * 2 * K * SP : 0);
    float* red = smem + 2 * K * SP;     // [2][NW] maxima (MAXNT > 32)
    float* edge = red + 2 * NW;         // [2][NW] last new value a warp
    const size_t rowoff = (size_t)b * L;
    const int l0 = (rank * NT + rt) * P;
    const bool wide = S % 4 == 0
        && (reinterpret_cast<size_t>(lp) & 15) == 0;
    PhaseClock<CLOCK, FWD_PHASES> clk;
    auto row_sync = [&]() {
        if (MAXNT == 32)
            __syncwarp();
        else
            __syncthreads();
    };

    // per position: its packed columns and flags, the weight of its mod
    // column, the state
    unsigned pw[P];
    float mf[P], f[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = l0 + p;
        unsigned w = (unsigned)S | (unsigned)S << 8 | (unsigned)S << 16;
        float fact = 0.f, v = NEG;
        if (l < L) {
            const bool ok = valid[rowoff + l] != 0;
            w = col8(stay_idx[rowoff + l], S);
            if (l > 0) {
                const bool mok = ok && valid[rowoff + l - 1] != 0;
                w |= col8(move_idx[rowoff + l - 1], S) << 8
                    | col8(mod_idx[rowoff + l - 1], S) << 16
                    | (mok ? MOK_BIT : 0u);
                fact = mod_fact[rowoff + l - 1];
            } else {
                w |= (unsigned)S << 8 | (unsigned)S << 16;
                if (ok) v = 0.f;
            }
            w |= ok ? OK_BIT : 0u;
        }
        pw[p] = w;
        mf[p] = fact;
        f[p] = v;
    }
    // the ring's padding columns read 0; the first batch's rows
    for (int i = rt; i < 2 * K; i += NT)
        for (int j = S; j < SP; ++j) ring[i * SP + j] = 0.f;
    fwd_copy_rows(ring, lp, 0, min(K, T), B, S, SP, b, wide, rt, NT);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const float* peer_red = CL == 1 ? red
        : cluster.map_shared_rank(red, rank ^ 1);
    const float* peer_edge = peer_red + 2 * NW;
    float score = 0.f;
    float below = NEG;  // lane 0: the position below its first, renormalised
    clk.start();
    for (int s0 = 0; s0 < T; s0 += K) {
        const int n = min(K, T - s0);
        const float* rows = ring + ((s0 / K) & 1) * K * SP;
        // this batch's rows have landed, and every thread of the row is
        // done with the last batch's: the next batch's rows start
        cp_async_wait_all();
        row_sync();
        if (s0 + K < T)
            fwd_copy_rows(ring + (((s0 / K) & 1) ^ 1) * K * SP, lp, s0 + K,
                          min(K, T - s0 - K), B, S, SP, b, wide, rt, NT);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        clk.lap(0);

        for (int k = 0; k < n; ++k) {
            const int t = s0 + k, par = t & 1;
            const float* row = rows + k * SP;
            if (lattice != nullptr)
                fwd_store<P>(lattice + ((size_t)t * B + b) * L, l0, f, L);
            clk.lap(1);
            float up = __shfl_up_sync(FULL, f[P - 1], 1);
            if (lane == 0) up = below;
            float nw[P], m = NEG;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const unsigned w = pw[p];
                const float stay = f[p] + row[w & 0xff];
                const unsigned mc = (w >> 16) & 0xff;
                float mv = row[(w >> 8) & 0xff];
                if (mc < (unsigned)S) mv = mod_fold(mv, mf[p], row[mc]);
                const float move = (w & MOK_BIT)
                    ? (p == 0 ? up : f[p > 0 ? p - 1 : 0]) + mv : NEG;
                nw[p] = (w & OK_BIT) ? (FAST ? logaddexp_fast(stay, move)
                                             : logaddexpf_(stay, move))
                                     : NEG;
                m = fmaxf(m, nw[p]);
            }
            m = warp_max_redux(m);
            clk.lap(2);
            float factor = m;
            if (MAXNT > 32) {
                if (lane == 0) red[par * NW + warp] = m;
                if (lane == 31) edge[par * NW + warp] = nw[P - 1];
                if (CL == 1)
                    __syncthreads();
                else
                    cluster.sync();
                float r = lane < NW ? red[par * NW + lane] : NEG;
                if (CL > 1 && lane < NW)
                    r = fmaxf(r, peer_red[par * NW + lane]);
                factor = warp_max_redux(r);
                if (lane == 0) {
                    const float e = warp > 0 ? edge[par * NW + warp - 1]
                        : rank > 0 ? peer_edge[par * NW + NW - 1] : NEG;
                    below = e - factor;
                }
            }
#pragma unroll
            for (int p = 0; p < P; ++p)
                f[p] = (pw[p] & OK_BIT) ? nw[p] - factor : NEG;
            score += factor;
            clk.lap(3);
        }
    }
    fwd_store<P>(fwd_final + rowoff, l0, f, L);
    if (rank == 0 && rt == 0) {
        score_out[b] = score;
        if (CLOCK) clk.store(cyc, b);
    }
    // the other CTA of the row may still read this one's shared memory
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

template <int MAXNT, int P, int CL, bool FAST, bool CLOCK>
int launch_fwd(const float* lp, const int* sidx, const int* midx,
               const int* mmidx, const float* mfact, const int* valid,
               float* fwd_final, float* score, float* lattice, int T, int B,
               int S, int L, int K, int NT, long long* cyc, cudaStream_t st)
{
    if (K < 1 || NT > MAXNT || NT % 32 || (MAXNT == 32) != (NT == 32)
            || L > NT * P * CL)
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = crf_fwd_kernel<MAXNT, P, CL, FAST, CLOCK>;
    const size_t smem = fwd_smem(NT, S, K);
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
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, lp, sidx, midx, mmidx,
                                       mfact, valid, fwd_final, score,
                                       lattice, T, B, S, L, K, cyc);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
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

// ---- kernels 9-10: the recursions on selected score streams --------------

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

template <int NT, int P>
__global__ void __launch_bounds__(NT)
crf_fwd_streams_kernel(const float* __restrict__ stay,
                       const float* __restrict__ move,
                       const int* __restrict__ valid,
                       float* __restrict__ fwd_final,
                       float* __restrict__ score_out,
                       float* __restrict__ lattice, int T, int B, int L)
{
    constexpr int NW = NT / 32;
    extern __shared__ __align__(16) float smem[];
    float* state = smem;                       // [2][L], unrenormalised
    float* red = smem + 2 * L;                 // [2][NW]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;

    // per position: validity, this step's stay score and the score of the
    // move into it (column l - 1)
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

    float prev = 0.f, score = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* cur = state + (t & 1) * L;
        float* nxt = state + ((t + 1) & 1) * L;
        const size_t off = (size_t)(t + 1) * tstride + row;
        float nst[P], nmv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {           // step t + 1's loads first
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
        prev = block_max<NT>(m, red + (t & 1) * NW, lane, warp);
        score += prev;
    }
    const float* fin = state + (T & 1) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int l = tid + p * NT;
        if (l < L) fwd_final[row + l] = ok[p] ? fin[l] - prev : NEG;
    }
    if (tid == 0) score_out[blockIdx.x] = score;
}

template <int NT, int P>
__global__ void __launch_bounds__(NT)
crf_bwd_posteriors_kernel(const float* __restrict__ stay,
                          const float* __restrict__ move,
                          const float* __restrict__ lattice,
                          const int* __restrict__ valid,
                          const int* __restrict__ lastpos,
                          float* __restrict__ post_stay,
                          float* __restrict__ post_move, int T, int B, int L)
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

    // per position: validity, whether the move out of it (to l + 1) is
    // allowed, and this step's stay and move scores and forward lattice
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

    float prev = 0.f;
    for (int s = 0; s < T; ++s) {
        const int t = T - 1 - s;
        const int buf = s & 1;
        const float* cur = state + buf * L;
        float* nxt = state + (buf ^ 1) * L;
        const size_t off = (size_t)(t > 0 ? t - 1 : 0) * tstride + row;
        float nst[P], nmv[P], nfc[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {           // step t - 1's loads first
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
        __syncthreads();
        float tmax = r[0], factor = r[NW];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
            tmax = fmaxf(tmax, r[w]);
            factor = fmaxf(factor, r[NW + w]);
        }
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            ts[p] = ts[p] > 0.5f * NEG ? expf(ts[p] - tmax) : 0.f;
            tm[p] = tm[p] > 0.5f * NEG ? expf(tm[p] - tmax) : 0.f;
            part += ts[p] + tm[p];
        }
        part = warp_sum(part);
        if (lane == 0) sums[buf * NW + warp] = part;
        __syncthreads();
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) den += sums[buf * NW + w];
        // a row with no path gets all-zero posteriors (pallas_crf.py:197)
        den = den > 0.f ? den : 1.f;
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
    }
}

template <int NT, int P>
int launch_fwd_streams(const float* stay, const float* move,
                       const int* valid, float* fwd_final, float* score,
                       float* lattice, int T, int B, int L, cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 2 * (NT / 32));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_fwd_streams_kernel<NT, P>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_fwd_streams_kernel<NT, P><<<B, NT, smem, st>>>(
        stay, move, valid, fwd_final, score, lattice, T, B, L);
    return static_cast<int>(cudaGetLastError());
}

template <int NT, int P>
int launch_bwd_posteriors(const float* stay, const float* move,
                          const float* lattice, const int* valid,
                          const int* last, float* post_stay,
                          float* post_move, int T, int B, int L,
                          cudaStream_t st)
{
    const size_t smem = sizeof(float) * (2 * L + 6 * (NT / 32));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            crf_bwd_posteriors_kernel<NT, P>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    crf_bwd_posteriors_kernel<NT, P><<<B, NT, smem, st>>>(
        stay, move, lattice, valid, last, post_stay, post_move, T, B, L);
    return static_cast<int>(cudaGetLastError());
}

// The instances past MAX_L_SMEM positions: the [2][L] vector of each row in
// device memory (gstate [B, 2, L]), any L.
constexpr int MAX_L_SMEM = 16384;
constexpr int GMEM_NT = 1024;

template <int NT>
__global__ void __launch_bounds__(NT)
crf_fwd_streams_gmem_kernel(const float* __restrict__ stay,
                            const float* __restrict__ move,
                            const int* __restrict__ valid,
                            float* __restrict__ fwd_final,
                            float* __restrict__ score_out,
                            float* __restrict__ lattice, float* gstate,
                            int T, int B, int L)
{
    constexpr int NW = NT / 32;
    __shared__ float red[2 * NW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    float* state = gstate + 2 * row;           // [2][L], unrenormalised

    for (int l = tid; l < L; l += NT)
        state[l] = (l == 0 && valid[row + l] != 0) ? 0.f : NEG;
    __syncthreads();

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
        prev = block_max<NT>(m, red + (t & 1) * NW, lane, warp);
        score += prev;
    }
    const float* fin = state + (T & 1) * L;
    for (int l = tid; l < L; l += NT)
        fwd_final[row + l] = valid[row + l] != 0 ? fin[l] - prev : NEG;
    if (tid == 0) score_out[blockIdx.x] = score;
}

template <int NT>
__global__ void __launch_bounds__(NT)
crf_bwd_posteriors_gmem_kernel(const float* __restrict__ stay,
                               const float* __restrict__ move,
                               const float* __restrict__ lattice,
                               const int* __restrict__ valid,
                               const int* __restrict__ lastpos,
                               float* __restrict__ post_stay,
                               float* __restrict__ post_move,
                               float* gstate, int T, int B, int L)
{
    constexpr int NW = NT / 32;
    __shared__ float red[4 * NW];              // [2][2][NW] term and state max
    __shared__ float sums[2 * NW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t tstride = (size_t)B * L;
    const int last = lastpos[blockIdx.x];
    float* state = gstate + 2 * row;           // [2][L], unrenormalised

    for (int l = tid; l < L; l += NT)
        state[l] = (l == last && valid[row + l] != 0) ? 0.f : NEG;
    __syncthreads();

    float prev = 0.f;
    for (int s = 0; s < T; ++s) {
        const int t = T - 1 - s;
        const int buf = s & 1;
        const float* cur = state + buf * L;
        float* nxt = state + (buf ^ 1) * L;
        const size_t off = (size_t)t * tstride + row;
        // the step's new state, and the max of its transition terms
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
        __syncthreads();
        float tmax = r[0], factor = r[NW];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
            tmax = fmaxf(tmax, r[w]);
            factor = fmaxf(factor, r[NW + w]);
        }
        // the terms again (cur is not written before the next barrier),
        // exponentiated into the outputs
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
        __syncthreads();
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) den += sums[buf * NW + w];
        // a row with no path gets all-zero posteriors (pallas_crf.py:197)
        den = den > 0.f ? den : 1.f;
        for (int l = tid; l < L; l += NT) {
            post_stay[off + l] = post_stay[off + l] / den;
            post_move[off + l] = post_move[off + l] / den;
        }
        prev = factor;
    }
}

}  // namespace

// (threads, positions per thread) by lattice width: up to 16384 positions
// in shared memory
#define TT_STREAM_CASES(CALL)                                   \
    if (L <= 256) return CALL(256, 1);                          \
    if (L <= 512) return CALL(256, 2);                          \
    if (L <= 1024) return CALL(256, 4);                         \
    if (L <= 2048) return CALL(256, 8);                         \
    if (L <= 4096) return CALL(512, 8);                         \
    if (L <= 8192) return CALL(1024, 8);                        \
    if (L <= 16384) return CALL(1024, 16);                      \
    return static_cast<int>(cudaErrorInvalidValue);

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
// 16384 positions the vector lives in gstate [B, 2, L] (scratch; may be
// null below).
int tt_crf_fwd_streams(const float* stay, const float* move,
                       const int* valid, float* fwd_final, float* score,
                       float* lattice, float* gstate, int T, int B, int L,
                       void* stream)
{
    if (B == 0 || L == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (L > MAX_L_SMEM) {
        if (gstate == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
        crf_fwd_streams_gmem_kernel<GMEM_NT><<<B, GMEM_NT, 0, st>>>(
            stay, move, valid, fwd_final, score, lattice, gstate, T, B, L);
        return static_cast<int>(cudaGetLastError());
    }
#define TT_FWDS(NT, P) launch_fwd_streams<NT, P>(                     \
        stay, move, valid, fwd_final, score, lattice, T, B, L, st)
    TT_STREAM_CASES(TT_FWDS)
#undef TT_FWDS
}

// ... + lattice [T, B, L] of tt_crf_fwd_streams, last [B] int32 ->
// post_stay, post_move [T, B, L]; gstate as tt_crf_fwd_streams'.
int tt_crf_bwd_posteriors(const float* stay, const float* move,
                          const float* lattice, const int* valid,
                          const int* last, float* post_stay,
                          float* post_move, float* gstate, int T, int B,
                          int L, void* stream)
{
    if (B == 0 || T == 0 || L == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (L > MAX_L_SMEM) {
        if (gstate == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
        crf_bwd_posteriors_gmem_kernel<GMEM_NT><<<B, GMEM_NT, 0, st>>>(
            stay, move, lattice, valid, last, post_stay, post_move, gstate,
            T, B, L);
        return static_cast<int>(cudaGetLastError());
    }
#define TT_BWDP(NT, P) launch_bwd_posteriors<NT, P>(                  \
        stay, move, lattice, valid, last, post_stay, post_move, T, B, L, st)
    TT_STREAM_CASES(TT_BWDP)
#undef TT_BWDP
}

}  // extern "C"
