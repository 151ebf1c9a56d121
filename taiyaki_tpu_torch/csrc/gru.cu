// GRU layer forward and backwards for Hopper (sm_90a), f32 arithmetic,
// f32 or bf16 streams.
//
// The cell (CUDNN gate order r, z, n; no hidden bias):
//     r = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z),
//     n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h,
// with gx = x . iW^T + b and gh = h . sW^T.  `reverse` walks time backwards
// and keeps the outputs in natural time order.  T is taken as it is (no
// time padding, no masked rows).
//
// Forward (tt_gru_fwd) replaces the TPU kernel
// taiyaki_tpu/ops/pallas_rnn.py:995 `gru_fused_fwd`: h of the layer, for
// inference and for the recomputing backward (emit_residuals=False), or
// with gh beside it and gx (the f32 instance keeps its gx scratch as the
// output, the bf16 one writes a bf16 copy) (emit_residuals=True), for the
// backward from stored gate streams.
//
// Backwards, each to d_x, d_sW, d_iW and d_b, the weight gradients as
// partial sums for the caller to add up:
// - tt_gru_bwd replaces pallas_rnn.py:1311 `gru_bwd_recompute`: from dh,
//   h and x (no stored gate streams) it rebuilds gx and gh;
// - tt_gru_bwd_fusedw replaces pallas_rnn.py:1184 `gru_bwd_fusedw`: from
//   dh and the forward's gx, gh and h_prev.
//
// The recurrence on given gates, without the input product (the public
// op `gru_scan` of ops/rnn.py), runs the same chains:
// - tt_gru_scan_fwd replaces pallas_rnn.py:1082 `gru_fwd`: h, and with gh
//   non-null gh beside it, from gates_x [T, B, 3H] (kernel 2, reading the
//   caller's gates, never writing them);
// - tt_gru_scan_bwd replaces pallas_rnn.py:1407 `gru_bwd`: dgx and dgh
//   [T, B, 3H] from dh, gates_x, gh and h_prev (kernel 3 with scratch of
//   its own), and with iW also d_x = dgx . iW by kernel 1 from the stored
//   dgx, the product the TPU kernel forms in its body
//   (`_gru_bwd_dx_kernel`).
// Bound: the serial chain, as for the layer kernels (at T=2000, B=256,
// H=256 the operations bound is 3.0 ms and the bytes bound 1.1-2.2 ms,
// against tens of ms of chain).
//
// Kernels:
//
// 1. The gate GEMM (gemm.cuh), on its plan's instance (ops/gemm.py): the
//    tc kernel (3xTF32 on the tensor cores, TMA-fed, gemm_tc.cuh) or, for
//    ragged widths, gate_gemm_kernel (f32 FMA).  Forward: gx = x . iW^T +
//    b [T, B, 3H], which the TPU kernel computes per time block in its
//    body.  Recomputing
//    backward: gx again, gh = h_prev . sW^T for all steps at once (the TPU
//    kernel forms it step by step inside its serial loop,
//    pallas_rnn.py:1264-1268; here h is wholly known before the backward
//    starts, so the product leaves the chain).  Both backwards, after the
//    chain: d_x = dgx . iW.  Bound: operations (tc: 6MNK FLOP at the 495
//    TFLOP/s TF32 rate; simt: 2MNK at the 67 TFLOP/s f32 rate).  The two
//    [T, B, 3H] operands (1.57 GB each at T=2000, B=256, H=256) make a
//    round trip through device memory that the TPU kernel avoids, ~1 ms at
//    3.35 TB/s against ~100 ms of chain.
//
// 2. The forward recurrence, in two instances that compute the same
//    function (within 1e-5 of each other; the sums over k run in another
//    order), as the LSTM's (lstm.cu item 2); ops/rnn_plan.py `rec_plan`
//    picks one by shape before the launch.  Both replace the recurrence
//    of pallas_rnn.py:995 `gru_fused_fwd` (and, on given gates, of
//    pallas_rnn.py:1082 `gru_fwd`).
//    a. gru_rec_cluster_kernel<RB, RES, BF16> (the cluster instance, the
//       plan's choice wherever it fits, up to H ~ 450): a cluster of C
//       CTAs per tile of BT batch rows, rank q keeping the three gate
//       rows of its H/C units over all H inputs in shared memory for the
//       whole launch (as float4 with a zero fourth gate: 72 KB at the shipped remap
//       model's H = 96 with C = 2, 128 KB at H = 256, C = 8), h exchanged
//       by bulk copies between the ranks' shared memories with one
//       mbarrier wait a step, the product in KS slices of k, the cells
//       after it, the next step's input gates copied by cp.async during
//       the product (rec_cluster.cuh: layout, protocol, per-step cost
//       model).  The input gates are added after the product, as in the L2
//       instance, and h_prev is read from the CTA's own h buffer.  At the
//       basecall shape (B = 128) the plan runs 128 CTAs at H = 96 (C = 2,
//       BT = 2) and 120 at H = 256 (C = 8, BT = 9); the L2 instance 16.
//       Bound: the serial chain of T steps, each the product's
//       shared-memory reads plus the exchange and the cells; at H = 96
//       the fixed costs of a step (the cells, the exchange), not the
//       product, take most of it.
//    b. gru_rec_kernel<BT, RES, BF16> (the L2 instance, where the slice
//       does not fit: H = 512).  One block per tile of BT = 8 batch rows,
//       one thread per hidden unit j owning the gate rows j, H+j and 2H+j
//       for the BT rows (24 accumulators) and its h in registers; h of the
//       tile lives in shared memory, double-buffered so one barrier per
//       step suffices; every step reads sW^T again from L2 (coalesced:
//       thread j reads column j of each row).
//    With RES either stores the step's gh, a value it holds anyway, and
//    the bf16 instance a bf16 copy of the step's gx.
//
// 3. The backward recurrence, walking opposite to the forward, in two
//    instances that compute the same function (within 1e-4 relative; the
//    sums over the gates run in another order), picked by ops/rnn_plan.py
//    `bwd_plan` before the launch as the LSTM's (lstm.cu item 3).  It
//    carries only dh: per step each cell (unit k, row) reads gx, gh and
//    h_prev and forms
//        dz = dh (h_prev - n),  dn_pre = dh (1 - z)(1 - n^2),
//        dr_pre = dn_pre gh_n r (1 - r),  dz_pre = dz z (1 - z),
//        dgx = [dr_pre, dz_pre, dn_pre],  dgh = [dr_pre, dz_pre, dn_pre r],
//    (pallas_rnn.py:1120-1137), writes dgx and dgh, sums d_b per batch
//    tile, and then
//        dh_prev[k] = sum_g dgh[g] sW[g, k] + dh z.
//    a. gru_bwd_rec_cluster_kernel<RB, KL, CLOCK, TG, BF16> (the cluster
//       instance, wherever it fits: every width the repo's models use):
//       rank q keeps the three
//       gate rows of sW of its units over all H columns in shared memory
//       (96 KB at H = 256, C = 8), forms a partial dh_prev over all H units
//       from its own dgh, and sends each rank its block by a bulk copy;
//       the owner sums the C partials in rank order and adds dh z, which
//       it carries in registers (rec_cluster.cuh, the backward).  The next
//       step's 8 input words of a cell arrive by cp.async during the
//       product (the bf16 instances: the tile's words as runs of U units,
//       copied by all threads).  At B = 256, H = 256: C = 8, BT = 18, 120
//       CTAs.
//    b. gru_bwd_rec_kernel<BT, TG, BF16> (the L2 instance, where the slice
//       does not fit: H = 512): thread k the cells of unit k for a tile of
//       8 rows,
//       dgh of the tile in shared memory (double-buffered, 48 KB at H =
//       256), column k of sW (3H values) read from L2 each step.
//    Bound: the serial chain.  The recomputing backward passes its gx and
//    gh scratch as dgx and dgh too, so the gradients overwrite them and no
//    third stream is needed; the backward from stored streams must leave
//    the forward's gx and gh as they are (autograd keeps them, and a
//    retained graph reads them again) and writes to scratch of its own.
//    Every load of a row precedes its stores in both instances, so either
//    way is safe.  h_prev is read from a stream at a time offset: h one
//    step back in the forward's direction (recompute) or h_prev itself
//    (offset 0).
//
// 4. The atb GEMM (gemm.cuh; the tc kernel or atb_gemm_kernel, as 1):
//    d_iW = dgx^T x and d_sW = dgh^T h_prev as
//    split-K partials over slices of the T*B rows, h_prev read from h by
//    a -B (forward layer) or +B (reversed layer) row shift, or from
//    h_prev as it is.  The TPU kernels accumulate them in VMEM across
//    their sequential time grid; Hopper blocks carry nothing across blocks.
//
// Rows of the last batch tile past B run on zeros and are never stored.
//
// Streams (`streams`, STREAM_* below, the bits of csrc/lstm.cu).  The f32
// instances read and write f32 alone.  The bf16 instances store what the
// JAX package's TPU kernels store under its mixed precision
// (taiyaki_tpu/ops/rnn.py:29-42, :612-700; the port's
// TAIYAKI_TPU_BF16_STREAMS=1): the forward writes gh and a bf16 copy of
// the gx it reads as the residuals (pallas_rnn.py:959-993; the f32 gx
// scratch, the TPU kernel's f32 VMEM, is never handed back as the
// residual) and h in bf16 or f32 (the act stream), while the carry h
// stays f32 in registers and shared memory; the backward chains read dh
// and h_prev (bf16 or f32, run-time flags) and the gate streams (the
// recompute's rebuilt f32 scratch, row 8, or the stored bf16 residuals,
// row 13) and widen each value at load (_gru_cell_bwd, pallas_rnn.py:
// 1120-1137); the chain, dgx and dgh stay f32, and d_x is written in x's
// type.  The GEMMs take x and h in bf16 where the layer holds them so
// (gemm.cuh).  The forward kernels are templated on the residuals' type
// (h's type a run-time flag), the chains on the gate streams' type with
// dh's and h_prev's types run-time flags of the bf16 instance, so that the
// instances double (the chains: f32; f32 gates with the flags; bf16
// gates), not quadruple.  The chains' bf16 instances lay the cluster
// instance's ring out word-major, [8][BT][U] in each word's own type
// (2 bytes a bf16 unit, 4 an f32 one, whatever the flags say), and fill
// it by cp.async of whole runs of U units, the CTA's threads sharing the
// copies; the cells widen each word at use (rec_cluster.cuh, the bf16
// chains' ring).  The in-place chain (row 8) only ever pairs f32 gates
// with f32 gradients.  The recurrence on given gates under the JAX scans'
// mixed precision (taiyaki_tpu/ops/rnn.py:542-588): the forward's bf16
// instance on the caller's gate stream in bf16 (GX16: the gates through
// registers, rec_cluster.cuh) or f32, h f32, gh bf16, and no gx copy (the
// caller keeps gx); the stored chain's bf16 instance (bf16 gh) with gx's
// type a run-time flag (f32 under TAIYAKI_TPU_F32_GATES) and dgx and dgh
// stored in dh's type (the run-time flag d_bf16), rounded where they are
// stored while the chain goes on from the f32 values
// (pallas_rnn.py:1388-1392), the layers passing 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "gemm.cuh"
#include "rec_cluster.cuh"

namespace {

// the entry points' `streams` bits: which tensors are bf16
constexpr int STREAM_X_BF16 = 1;     // the layer input x (and d_x)
constexpr int STREAM_H_BF16 = 2;     // h (the backwards' h_prev)
constexpr int STREAM_RES_BF16 = 4;   // the residuals gh and gx
constexpr int STREAM_DH_BF16 = 8;    // dh (and dgx and dgh, as the scan's
                                     // chain stores them)
constexpr int STREAM_ALL = 15;       // what the layers' entry points take

// the residual streams' type of a forward instance
template <bool BF16>
using res_t = typename std::conditional<BF16, bf16, float>::type;

// the gate stream's type of a forward instance: bf16 with GX16 (the bf16
// instance on a bf16 gate stream, the scans)
template <bool GX16>
using gx_t = typename std::conditional<GX16, bf16, float>::type;

// v into a stream of f32, or of bf16 where the bf16 instance's flag `bf`
// says so
template <bool BF16>
__device__ __forceinline__ void store_f(void* p, size_t o, float v, int bf)
{
    if (BF16 && bf)
        static_cast<bf16*>(p)[o] = __float2bfloat16_rn(v);
    else
        static_cast<float*>(p)[o] = v;
}

// a value of a stream of f32, or of bf16 (widened) as store_f
template <bool BF16>
__device__ __forceinline__ float load_f(const void* p, size_t o, int bf)
{
    if (BF16 && bf) return widen(static_cast<const bf16*>(p)[o]);
    return static_cast<const float*>(p)[o];
}

// `p` advanced by n elements of f32, or of bf16 with `bf`
inline const void* advance(const void* p, size_t n, bool bf)
{
    return static_cast<const char*>(p) + n * (bf ? 2 : 4);
}

__device__ __forceinline__ float sigmoidf_(float x)
{
    return 1.f / (1.f + expf(-x));
}

constexpr int REC_BT = 8;          // batch rows per block
constexpr int REC_MAX_THREADS = 512;

// h[t, b, :] for the BT-row batch tile of this block; with RES also
// gh[t, b, :] = h_prev . sW^T.
// gx [T, B, 3H] (input gates incl. bias; bf16 with GX16), swt [H, 3H] =
// sW^T, h [T, B, H] (bf16 with h_bf16 in the bf16 instance), gh [T, B, 3H]
// in res_t<BF16>; with RES the bf16 instance also writes gx_out [T, B,
// 3H], gx in bf16, where gx_out is not null.
template <int BT, bool RES, bool BF16 = false, bool GX16 = false>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_rec_kernel(const gx_t<GX16>* __restrict__ gx,
               const float* __restrict__ swt,
               void* __restrict__ h_out, res_t<BF16>* __restrict__ gh_out,
               res_t<BF16>* __restrict__ gx_out, int T, int B, int H,
               int reverse, int h_bf16)
{
    static_assert(BF16 || !GX16, "a bf16 gate stream: the bf16 instance");
    using R = res_t<BF16>;
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
            const gx_t<GX16>* g = gx + row * H3 + j;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float g0 = 0.f, g1 = 0.f, g2 = 0.f;
                if (r < nrow) {
                    const gx_t<GX16>* gr = g + (size_t)r * H3;
                    g0 = widen(gr[0]); g1 = widen(gr[H]);
                    g2 = widen(gr[2 * H]);
                    if (RES) {
                        R* o = gh_out + (row + r) * H3 + j;
                        o[0] = narrow<R>(acc[0][r]);
                        o[H] = narrow<R>(acc[1][r]);
                        o[2 * H] = narrow<R>(acc[2][r]);
                        if (BF16 && gx_out != nullptr) {
                            R* q = gx_out + (row + r) * H3 + j;
                            q[0] = narrow<R>(g0); q[H] = narrow<R>(g1);
                            q[2 * H] = narrow<R>(g2);
                        }
                    }
                }
                const float rg = sigmoidf_(g0 + acc[0][r]);
                const float zg = sigmoidf_(g1 + acc[1][r]);
                const float ng = tanhf(g2 + rg * acc[2][r]);
                const float h = (1.f - zg) * ng + zg * hr[r];
                hr[r] = h;
                hn[j * BT + r] = h;
                if (r < nrow)
                    store_f<BF16>(h_out, (row + r) * H + j, h, h_bf16);
            }
        }
        __syncthreads();
    }
}

// The cluster instance of the forward recurrence: what gru_rec_kernel
// computes, for the tile of BT rows of this cluster, rank q holding units
// [q U, q U + U); the product in KS k slices of RB rows a lane
// (rec_cluster.cuh).  Arguments as gru_rec_kernel's; C ranks of U units.
// With GX16 the bf16 gates go through registers (rec_step_top,
// rec_stash_gates).
template <int RB, bool RES, bool BF16 = false, bool GX16 = false>
__global__ void __launch_bounds__(REC_CLUSTER_THREADS, 1)
gru_rec_cluster_kernel(const gx_t<GX16>* __restrict__ gx,
                       const float* __restrict__ swt,
                       void* __restrict__ h_out,
                       res_t<BF16>* __restrict__ gh_out,
                       res_t<BF16>* __restrict__ gx_out, int T, int B, int H,
                       int reverse, int C, int U, int BT, int KS, int h_bf16)
{
    static_assert(BF16 || !GX16, "a bf16 gate stream: the bf16 instance");
    using R = res_t<BF16>;
    extern __shared__ __align__(16) float smem[];
    const RecSmem m = rec_smem(smem, H, C, U, BT);
    const int b0 = cluster_id() * BT;
    const int nrow = min(BT, B - b0);
    const int u0 = cluster_rank() * U;
    const RecWork wk = rec_work(H, U, KS);
    const bool works = wk.ul_c < U && u0 + wk.ul_c < H;
    const int H3 = 3 * H;

    const RecCells cl = rec_cells(H, U, BT, u0);
    rec_prologue<3>(m, gx, swt, reverse ? T - 1 : 0, B, b0, nrow, H, C, U,
                    u0, BT, cl);
    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        const int nb = (s + 1) & 1;
        const bool more = s + 1 < T;
        const float* hc = m.hS + (s & 1) * C * U * BT;
        float v[REC_MAX_CELLS][4];
        rec_step_top<3>(m, gx, v, s, T, reverse ? t - 1 : t + 1, B, b0, nrow,
                        H, C, U, u0, BT, cl);
        if (works) rec_partials<3, RB>(m, hc, wk, U, BT);
        if constexpr (GX16)
            if (more) rec_stash_gates<3>(m.ring + nb * BT * U * 4, v, nrow,
                                         H, U, u0, cl);
        __syncthreads();
        cp_async_wait<1>();
        const float4* g4 =
            reinterpret_cast<const float4*>(m.ring + (s & 1) * BT * U * 4);
#pragma unroll
        for (int j = 0; j < REC_MAX_CELLS; ++j) {
            if (j >= cl.n) break;
            const int u_c = cl.u_c[j], row = cl.row[j], u = u0 + u_c;
            if (row >= BT || u >= H) continue;
            const float4 gh = rec_sum(m, make_float4(0.f, 0.f, 0.f, 0.f), KS,
                                      U, BT, u_c, row);
            float g0 = 0.f, g1 = 0.f, g2 = 0.f;
            if (row < nrow) {
                const float4 g = g4[row * U + u_c];
                g0 = g.x; g1 = g.y; g2 = g.z;
            }
            const float rg = sigmoidf_(g0 + gh.x);
            const float zg = sigmoidf_(g1 + gh.y);
            const float ng = tanhf(g2 + rg * gh.z);
            const float h = (1.f - zg) * ng + zg * hc[(size_t)u * BT + row];
            m.hS[(size_t)(nb * C * U + u) * BT + row] = h;
            if (row < nrow) {
                const size_t r = (size_t)t * B + b0 + row;
                store_f<BF16>(h_out, r * H + u, h, h_bf16);
                if (RES) {
                    R* o = gh_out + r * H3 + u;
                    o[0] = narrow<R>(gh.x); o[H] = narrow<R>(gh.y);
                    o[2 * H] = narrow<R>(gh.z);
                    if (BF16 && gx_out != nullptr) {
                        R* q = gx_out + r * H3 + u;
                        q[0] = narrow<R>(g0); q[H] = narrow<R>(g1);
                        q[2 * H] = narrow<R>(g2);
                    }
                }
            }
        }
        if (more) {
            rec_send(m, nb, C, U, BT, u0);
            mbar_wait(m.bar + nb, (s >> 1) & 1);
        }
    }
    cluster_sync();
}

// Backward recurrence (the L2 instance) for the BT-row batch tile of this
// block.  dh [T, B, H] (gradient of the layer's output); h_prev of step t
// is hp[t + hshift] (zero outside [0, T)); gx, gh [T, B, 3H] the gate
// streams; dgx, dgh [T, B, 3H] their gradients, which may be gx and gh
// themselves; sw [3H, H] = sW; db_part [nbt, 3H] per-tile bias gradients.
// No __restrict__ on the four streams, for the in-place case: every load
// of a step precedes its stores.  The gate streams of type TG (bf16 only
// in the bf16 instance, and then never in place), gx f32 there too where
// gx_bf16 is 0 (the scans under TAIYAKI_TPU_F32_GATES); dh and h_prev f32,
// or bf16 with dh_bf16 / hp_bf16 in the bf16 instance; dgx and dgh f32, or
// bf16 with d_bf16 in the bf16 instance (rounded where they are stored;
// the chain goes on from the f32 values).
template <int BT, typename TG = float, bool BF16 = false>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_bwd_rec_kernel(const void* __restrict__ dh_out,
                   const void* __restrict__ hp, int hshift, const void* gx,
                   const TG* gh, void* dgx, void* dgh,
                   const float* __restrict__ sw, float* __restrict__ db_part,
                   int T, int B, int H, int reverse, int dh_bf16, int hp_bf16,
                   int gx_bf16, int d_bf16)
{
    static_assert(BF16 || !is_bf16<TG>, "bf16 gates: the bf16 instance");
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
        const int tp = t + hshift;
        const bool has_prev = tp >= 0 && tp < T;
        float* gcur = g_s + (s & 1) * H3 * BT;
        float dhz[BT];
        if (active) {
            const size_t row = (size_t)t * B + b0;
            // gx r, z, n; gh r, z, n; h_prev; dh of each row
            float v[BT][8];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
#pragma unroll
                for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
                if (r < nrow) {
                    const size_t og = (row + r) * H3 + k;
                    v[r][0] = load_f<BF16>(gx, og, gx_bf16);
                    v[r][1] = load_f<BF16>(gx, og + H, gx_bf16);
                    v[r][2] = load_f<BF16>(gx, og + 2 * H, gx_bf16);
                    v[r][3] = widen(gh[og]); v[r][4] = widen(gh[og + H]);
                    v[r][5] = widen(gh[og + 2 * H]);
                    if (has_prev)
                        v[r][6] = load_f<BF16>(
                            hp, ((size_t)tp * B + b0 + r) * H + k, hp_bf16);
                    v[r][7] = load_f<BF16>(dh_out, (row + r) * H + k,
                                           dh_bf16);
                }
            }
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float p[3] = {0.f, 0.f, 0.f};
                dhz[r] = 0.f;
                if (r < nrow) {
                    const size_t og = (row + r) * H3 + k;
                    const float rg = sigmoidf_(v[r][0] + v[r][3]);
                    const float zg = sigmoidf_(v[r][1] + v[r][4]);
                    const float ng = tanhf(v[r][2] + rg * v[r][5]);
                    const float dh = v[r][7] + dh_c[r];
                    const float dz = dh * (v[r][6] - ng);
                    const float dn_pre = dh * (1.f - zg) * (1.f - ng * ng);
                    p[0] = dn_pre * v[r][5] * rg * (1.f - rg);
                    p[1] = dz * zg * (1.f - zg);
                    p[2] = dn_pre * rg;
                    dhz[r] = dh * zg;
                    store_f<BF16>(dgx, og, p[0], d_bf16);
                    store_f<BF16>(dgx, og + H, p[1], d_bf16);
                    store_f<BF16>(dgx, og + 2 * H, dn_pre, d_bf16);
                    store_f<BF16>(dgh, og, p[0], d_bf16);
                    store_f<BF16>(dgh, og + H, p[1], d_bf16);
                    store_f<BF16>(dgh, og + 2 * H, p[2], d_bf16);
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
                    const float4 v4 =
                        *reinterpret_cast<const float4*>(gcur + g * BT + r);
                    gv[r] = v4.x; gv[r + 1] = v4.y;
                    gv[r + 2] = v4.z; gv[r + 3] = v4.w;
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

// Step t's inputs of this thread's cells into the ring [BT][U][8]: gx and
// gh (3 each), h_prev (zero where t + hshift is outside [0, T)) and dh, by
// cp.async (the f32 instance).  Rows past B are left alone (no cell reads
// them).  gx and gh may be the streams the chain writes its gradients
// over: never at row t before this step's cells (rec_cluster.cuh, the
// backward).
__device__ __forceinline__ void gru_bwd_prefetch(
    float* ring, const float* __restrict__ dh_out,
    const float* __restrict__ hp, int hshift, const float* gx,
    const float* gh, int t, int T, int B, int b0, int nrow, int H, int U,
    int u0, const RecCells& cl)
{
    const int tp = t + hshift;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        if (j < cl.n && cl.row[j] < nrow && u0 + cl.u_c[j] < H) {
            const int u = u0 + cl.u_c[j];
            const size_t r = (size_t)t * B + b0 + cl.row[j];
            float* d = ring + ((size_t)cl.row[j] * U + cl.u_c[j])
                       * rec_bwd_ring(3);
            const size_t og = r * 3 * H + u;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                cp_async4(d + q, gx + og + q * H, true);
                cp_async4(d + 3 + q, gh + og + q * H, true);
            }
            cp_async4(d + 6, has_prev
                      ? hp + ((size_t)tp * B + b0 + cl.row[j]) * H + u
                      : dh_out, has_prev);
            cp_async4(d + 7, dh_out + r * H + u, true);
        }
    }
}

// Step t's inputs of the tile into the bf16 instances' word-major ring
// [8][BT][U] (rec_cluster.cuh, the bf16 chains' ring): gx (f32, or bf16
// where the gates are bf16 and gx_bf16 says), gh (TG), h_prev (zero where
// t + hshift is outside [0, T)) and dh, each bf16 or f32 by its flag; this
// thread's share of the CTA's copies.  gx and gh may be the streams the
// chain writes its gradients over (the recompute's f32 scratch): the
// copies read row t -/+ 1 only after step t's cells (rec_cluster.cuh).
constexpr int GRU_BWD_WORDS = 8;

template <typename TG>
__device__ __forceinline__ int gru_gx_bytes(int gx_bf16)
{
    return is_bf16<TG> && gx_bf16 ? 2 : 4;
}

template <typename TG>
__device__ __forceinline__ void gru_bwd_ring_fill(
    float* ring, const void* dh, int dh_bf16, const void* hp, int hp_bf16,
    int hshift, const void* gx, int gx_bf16, const TG* gh, int t, int T,
    int B, int b0, int nrow, int H, int U, int u0, int BT)
{
    const int tp = t + hshift;
    const size_t wb = rec_opaque(BT * U);   // floats a word's region
    const RecRingGeo g2 = rec_ring_geo(2, H, U, u0, nrow, ring);
    const RecRingGeo g4 = rec_ring_geo(4, H, U, u0, nrow, ring);
    constexpr int he = sizeof(TG);
    const int xe = gru_gx_bytes<TG>(gx_bf16);
    const int pe = hp_bf16 ? 2 : 4, de = dh_bf16 ? 2 : 4;
    int i = threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q)
        rec_ring_word(ring + q * wb, gx, xe == 2 ? g2 : g4, xe, 3 * H, q * H,
                      t, true, B, b0, u0, i);
#pragma unroll
    for (int q = 0; q < 3; ++q)
        rec_ring_word(ring + (3 + q) * wb, gh, he == 2 ? g2 : g4, he, 3 * H,
                      q * H, t, true, B, b0, u0, i);
    rec_ring_word(ring + 6 * wb, hp, pe == 2 ? g2 : g4, pe, H, 0, tp,
                  tp >= 0 && tp < T, B, b0, u0, i);
    rec_ring_word(ring + 7 * wb, dh, de == 2 ? g2 : g4, de, H, 0, t, true, B,
                  b0, u0, i);
}

// The eight words of cell e (row U + u_c) from that ring, widened: the
// cells' inputs as the f32 instance reads them from its slot.
template <typename TG>
__device__ __forceinline__ void gru_bwd_words(
    float (&v)[GRU_BWD_WORDS], const float* ring, int BT, int U, int e,
    int gx_bf16, int hp_bf16, int dh_bf16)
{
    BT = rec_opaque(BT);   // the words' addresses: recomputed a step
    e = rec_opaque(e);
    const int gx16 = gru_gx_bytes<TG>(gx_bf16) == 2;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        v[q] = rec_ring_at(ring, q, BT, U, e, gx16);
        v[3 + q] = rec_ring_at<TG>(ring, 3 + q, BT, U, e);
    }
    v[6] = rec_ring_at(ring, 6, BT, U, e, hp_bf16);
    v[7] = rec_ring_at(ring, 7, BT, U, e, dh_bf16);
}

// The cluster instance of the backward recurrence: what gru_bwd_rec_kernel
// computes, for the tile of BT rows of this cluster, rank q holding the
// three gate rows of sW of units [q U, q U + U) and summing the partials
// of those units (rec_cluster.cuh, the backward).  Arguments as
// gru_bwd_rec_kernel's (dgx and dgh may be gx and gh); C ranks of U units;
// db_part [ceil(B / BT), 3H].  With CLOCK (probes/rec_phases.cu alone)
// the step's phases are timed into `cycles`; the layers pass nullptr.
// TG, BF16, dh_bf16, hp_bf16, gx_bf16 and d_bf16 as gru_bwd_rec_kernel's.
template <int RB, int KL, bool CLOCK = false, typename TG = float,
          bool BF16 = false>
__global__ void __launch_bounds__(REC_CLUSTER_THREADS, 1)
gru_bwd_rec_cluster_kernel(const void* __restrict__ dh_out,
                           const void* __restrict__ hp, int hshift,
                           const void* gx, const TG* gh, void* dgx,
                           void* dgh, const float* __restrict__ sw,
                           float* __restrict__ db_part, int T, int B, int H,
                           int reverse, int C, int U, int BT,
                           long long* __restrict__ cycles, int dh_bf16,
                           int hp_bf16, int gx_bf16, int d_bf16)
{
    static_assert(BF16 || !is_bf16<TG>, "bf16 gates: the bf16 instance");
    extern __shared__ __align__(16) float smem[];
    const RecBwdSmem m = rec_bwd_smem_of<3>(smem, H, C, U, BT);
    const int tile = cluster_id();
    const int b0 = tile * BT;
    const int nrow = min(BT, B - b0);
    const int q = cluster_rank();
    const int u0 = q * U;
    const int H3 = 3 * H;
    const RecCells cl = rec_cells(H, U, BT, u0);

    rec_bwd_prologue<3>(m, sw, H, U, u0, BT);
    if constexpr (BF16)
        gru_bwd_ring_fill<TG>(m.ring, dh_out, dh_bf16, hp, hp_bf16, hshift,
                              gx, gx_bf16, gh, reverse ? 0 : T - 1, T, B, b0,
                              nrow, H, U, u0, BT);
    else
        gru_bwd_prefetch(m.ring, static_cast<const float*>(dh_out),
                         static_cast<const float*>(hp), hshift,
                         static_cast<const float*>(gx), gh,
                         reverse ? 0 : T - 1, T, B, b0, nrow, H, U, u0, cl);
    cp_async_commit();
    cp_async_wait<0>();
    cluster_sync();
    // dhz: the carried dh z of each cell, added to the next step's dh
    float dhz[REC_MAX_CELLS], db[REC_MAX_CELLS][3];
#pragma unroll
    for (int j = 0; j < REC_MAX_CELLS; ++j) {
        dhz[j] = 0.f;
#pragma unroll
        for (int g = 0; g < 3; ++g) db[j][g] = 0.f;
    }
    RecClock<CLOCK> clk;

    for (int s = 0; s < T; ++s) {
        // the gradient chain walks opposite to the forward direction
        const int t = reverse ? s : T - 1 - s;
        const int nb = (s + 1) & 1;
        const bool more = s + 1 < T;
        clk.start();
        if (more && threadIdx.x == 0)
            mbar_arrive_expect(m.bar + nb, 4 * (C - 1) * U * BT);
        cp_async_wait<0>();
        clk.template lap<REC_TOP>();
        // the bf16 instances rebuild their cells at each step rather than
        // hold them through the product (its registers)
        const RecCells cells = BF16 ? rec_cells(H, rec_opaque(U), BT, u0)
                                    : cl;
#pragma unroll
        for (int j = 0; j < REC_MAX_CELLS; ++j) {
            if (j >= cells.n) break;
            const int u_c = cells.u_c[j], row = cells.row[j], u = u0 + u_c;
            if (row >= nrow || u >= H) continue;
            // the cell's words: its slot of the f32 ring, or widened from
            // the bf16 instances' word-major ring
            float vb[BF16 ? GRU_BWD_WORDS : 1];
            if constexpr (BF16)
                gru_bwd_words<TG>(vb, m.ring, BT, U, row * U + u_c, gx_bf16,
                                  hp_bf16, dh_bf16);
            const float* v = BF16 ? vb
                                  : m.ring + ((size_t)row * U + u_c)
                                                 * rec_bwd_ring(3);
            const float rg = sigmoidf_(v[0] + v[3]);
            const float zg = sigmoidf_(v[1] + v[4]);
            const float ng = tanhf(v[2] + rg * v[5]);
            const float dsum = s > 0 ? rec_bwd_sum(m, s & 1, C, q, U, BT,
                                                   u_c, row)
                                     : 0.f;
            const float dh = v[7] + (dsum + dhz[j]);
            const float dz = dh * (v[6] - ng);
            const float dn_pre = dh * (1.f - zg) * (1.f - ng * ng);
            const float4 p = make_float4(dn_pre * v[5] * rg * (1.f - rg),
                                         dz * zg * (1.f - zg), dn_pre * rg,
                                         0.f);
            dhz[j] = dh * zg;
            const size_t og = ((size_t)t * B + b0 + row) * H3 + u;
            store_f<BF16>(dgx, og, p.x, d_bf16);
            store_f<BF16>(dgx, og + H, p.y, d_bf16);
            store_f<BF16>(dgx, og + 2 * H, dn_pre, d_bf16);
            store_f<BF16>(dgh, og, p.x, d_bf16);
            store_f<BF16>(dgh, og + H, p.y, d_bf16);
            store_f<BF16>(dgh, og + 2 * H, p.z, d_bf16);
            db[j][0] += p.x;
            db[j][1] += p.y;
            db[j][2] += dn_pre;
            reinterpret_cast<float4*>(m.dS)[(size_t)row * U + u_c] = p;
        }
        clk.template lap<REC_CELLS>();
        if (more) {
            __syncthreads();
            const int tn = reverse ? t + 1 : t - 1;
            // the copies are in flight during the product
            if constexpr (BF16)
                gru_bwd_ring_fill<TG>(m.ring, dh_out, dh_bf16, hp, hp_bf16,
                                      hshift, gx, gx_bf16, gh, tn, T, B, b0,
                                      nrow, H, U, u0, BT);
            else
                gru_bwd_prefetch(m.ring, static_cast<const float*>(dh_out),
                                 static_cast<const float*>(hp), hshift,
                                 static_cast<const float*>(gx), gh, tn, T, B,
                                 b0, nrow, H, U, u0, cl);
            cp_async_commit();
            rec_bwd_partials<3, RB, KL>(m, m.part + (size_t)nb * C * U * BT,
                                        H, U, BT);
            // the shared ring: every thread's copies land before the send's
            // barrier publishes it to step s+1's cells
            if constexpr (BF16) cp_async_wait<0>();
            clk.template lap<REC_PRODUCT>();
            rec_bwd_send(m, nb, C, U, BT);
            clk.template lap<REC_SEND>();
            mbar_wait(m.bar + nb, (s >> 1) & 1);
            clk.template lap<REC_WAIT>();
        }
    }
    cluster_sync();
    // the bf16 instances' cells again, not held through the loop
    rec_bwd_store_db<3>(m, BF16 ? rec_cells(H, U, BT, u0) : cl, db, db_part,
                          tile, H, U, u0, nrow);
    clk.store(cycles);
}

template <bool RES, bool BF16, bool GX16>
int launch_gru_rec(const void* gx, const float* swt, void* h, void* gh,
                   void* gxr, int T, int B, int H, int reverse, int h_bf16,
                   cudaStream_t st)
{
    using R = res_t<BF16>;
    const auto kernel = gru_rec_kernel<REC_BT, RES, BF16, GX16>;
    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)kernel, smem))) return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    kernel<<<blocks, threads, smem, st>>>(
        static_cast<const gx_t<GX16>*>(gx), swt, h, static_cast<R*>(gh),
        static_cast<R*>(gxr), T, B, H, reverse, h_bf16);
    return static_cast<int>(cudaGetLastError());
}

// The cluster instance (kernel 2a) on a plan of C ranks, BT rows a tile,
// RB rows a lane and KS k slices.
template <int RB, bool RES, bool BF16, bool GX16>
int launch_gru_rec_cluster(const void* gx, const float* swt, void* h,
                           void* gh, void* gxr, int T, int B, int H,
                           int reverse, int h_bf16, int C, int BT, int KS,
                           int smem, cudaStream_t st)
{
    using R = res_t<BF16>;
    const int U = (H + C - 1) / C;
    return rec_cluster_launch(gru_rec_cluster_kernel<RB, RES, BF16, GX16>, C,
                              (B + BT - 1) / BT,
                              rec_cluster_threads(U, BT, RB, KS), smem, st,
                              static_cast<const gx_t<GX16>*>(gx), swt, h,
                              static_cast<R*>(gh),
                              static_cast<R*>(gxr), T, B, H, reverse, C, U,
                              BT, KS, h_bf16);
}

// Kernel 2 on a checked plan (rec_plan_check): the L2 or cluster instance.
template <bool RES, bool BF16, bool GX16>
int launch_gru_rec_plan_res(const void* gx, const float* swt, void* h,
                            void* gh, void* gxr, int T, int B, int H,
                            int reverse, int h_bf16, int instance, int C,
                            int BT, int RB, int KS, int smem,
                            cudaStream_t st)
{
    if (instance == INSTANCE_L2)
        return launch_gru_rec<RES, BF16, GX16>(gx, swt, h, gh, gxr, T, B, H,
                                               reverse, h_bf16, st);
    return rec_with_rb(RB, [&](auto rb) {
        return launch_gru_rec_cluster<decltype(rb)::value, RES, BF16, GX16>(
            gx, swt, h, gh, gxr, T, B, H, reverse, h_bf16, C, BT, KS, smem,
            st);
    });
}

// Kernel 2 of the f32 or bf16 instance (on a bf16 gate stream with
// GX16); gh non-null stores the residual gh (and, in the bf16 instance,
// gx into gxr where that is not null).
template <bool BF16, bool GX16 = false>
int launch_gru_rec_plan(const void* gx, const float* swt, void* h, void* gh,
                        void* gxr, int T, int B, int H, int reverse,
                        int h_bf16, int instance, int C, int BT, int RB,
                        int KS, int smem, cudaStream_t st)
{
    if (gh != nullptr)
        return launch_gru_rec_plan_res<true, BF16, GX16>(
            gx, swt, h, gh, gxr, T, B, H, reverse, h_bf16, instance, C, BT,
            RB, KS, smem, st);
    return launch_gru_rec_plan_res<false, BF16, GX16>(
        gx, swt, h, nullptr, nullptr, T, B, H, reverse, h_bf16, instance, C,
        BT, RB, KS, smem, st);
}

// The backward chain (kernel 3b, the L2 instance) alone: dgx, dgh and the
// per-tile d_b.
template <typename TG, bool BF16>
int launch_gru_bwd_rec(const void* dh, const void* hp, int hshift,
                       const void* gx, const TG* gh, void* dgx, void* dgh,
                       const float* sw, float* db_part, int T, int B, int H,
                       int reverse, int dh_bf16, int hp_bf16, int gx_bf16,
                       int d_bf16, cudaStream_t st)
{
    const auto kernel = gru_bwd_rec_kernel<REC_BT, TG, BF16>;
    const size_t smem = 2 * sizeof(float) * 3 * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)kernel, smem))) return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    kernel<<<blocks, threads, smem, st>>>(
        dh, hp, hshift, gx, gh, dgx, dgh, sw, db_part, T, B, H, reverse,
        dh_bf16, hp_bf16, gx_bf16, d_bf16);
    return static_cast<int>(cudaGetLastError());
}

// The cluster instance of the chain (kernel 3a) on a plan of C ranks, BT
// rows a tile and RB rows a lane.
template <int RB, int KL, typename TG, bool BF16>
int launch_gru_bwd_rec_cluster(const void* dh, const void* hp, int hshift,
                               const void* gx, const TG* gh, void* dgx,
                               void* dgh, const float* sw, float* db_part,
                               int T, int B, int H, int reverse, int dh_bf16,
                               int hp_bf16, int gx_bf16, int d_bf16, int C,
                               int BT, int smem, cudaStream_t st)
{
    const int U = (H + C - 1) / C;
    return rec_cluster_launch(
        gru_bwd_rec_cluster_kernel<RB, KL, false, TG, BF16>, C,
        (B + BT - 1) / BT, rec_bwd_threads(H, BT, RB, KL), smem, st, dh, hp,
        hshift, gx, gh, dgx, dgh, sw, db_part, T, B, H, reverse, C, U, BT,
        static_cast<long long*>(nullptr), dh_bf16, hp_bf16, gx_bf16, d_bf16);
}

// Kernel 3 on a checked plan (rec_bwd_plan_check): the L2 or cluster
// instance; gx of type TG (or, in the bf16 instance of bf16 gh, f32 with
// gx_bf16 0), dgx and dgh f32 (or bf16 with d_bf16, the bf16 instance).
template <typename TG, bool BF16>
int launch_gru_bwd_rec_plan(const void* dh, const void* hp, int hshift,
                            const void* gx, const TG* gh, void* dgx,
                            void* dgh, const float* sw, float* db_part,
                            int T, int B, int H, int reverse, int dh_bf16,
                            int hp_bf16, int gx_bf16, int d_bf16,
                            int instance, int C, int BT, int RB, int KL,
                            int smem, cudaStream_t st)
{
    if (instance == INSTANCE_L2)
        return launch_gru_bwd_rec<TG, BF16>(dh, hp, hshift, gx, gh, dgx, dgh,
                                            sw, db_part, T, B, H, reverse,
                                            dh_bf16, hp_bf16, gx_bf16, d_bf16,
                                            st);
    return rec_with_rb_kl(RB, KL, [&](auto rb, auto kl) {
        return launch_gru_bwd_rec_cluster<decltype(rb)::value,
                                          decltype(kl)::value, TG, BF16>(
            dh, hp, hshift, gx, gh, dgx, dgh, sw, db_part, T, B, H, reverse,
            dh_bf16, hp_bf16, gx_bf16, d_bf16, C, BT, smem, st);
    });
}

// The chain (kernel 3, on the plan's instance) and the three products
// after it (d_x, d_iW, d_sW, on the GEMM plans gemm[0..2], checked by
// chain_plans_check); h_prev of step t is hp[t + hshift]; dh, hp, x and
// dx of the types `streams` gives.
template <typename TG, bool BF16>
int gru_bwd_chain(const void* dh, const void* hp, int hshift, const TG* gx,
                  const TG* gh, float* dgx, float* dgh, const void* x,
                  const float* sw, const float* iwt, void* dx,
                  float* dsw_part, float* diw_part, float* db_part, int T,
                  int B, int D, int H, int reverse, int streams,
                  const int* gemm, int instance, int C, int BT, int RB,
                  int KL, int smem, cudaStream_t st)
{
    const int M = T * B, H3 = 3 * H;
    const bool xb = streams & STREAM_X_BF16;
    const bool hb = streams & STREAM_H_BF16;
    int rc = launch_gru_bwd_rec_plan<TG, BF16>(
        dh, hp, hshift, gx, gh, dgx, dgh, sw, db_part, T, B, H, reverse,
        (streams & STREAM_DH_BF16) != 0, hb, is_bf16<TG>, 0, instance, C, BT,
        RB, KL, smem, st);
    if (rc) return rc;
    cudaError_t err;
    if ((err = gemm_gate(gemm_plan_at(gemm, 0), GemmIn{dgx, false}, iwt,
                         nullptr, GemmOut{dx, xb}, M, D, H3, st))
            != cudaSuccess)
        return static_cast<int>(err);
    if ((err = gemm_atb(gemm_plan_at(gemm, 1), dgx, GemmIn{x, xb}, diw_part,
                        M, H3, D, 0, st)) != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(gemm_atb(gemm_plan_at(gemm, 2), dgh,
                                     GemmIn{hp, hb}, dsw_part, M, H3, H,
                                     hshift * B, st));
}

// The streams a launch may take: all f32 (0), or the bf16 instance
// (STREAM_RES_BF16: bf16 residuals) with any of x, h and dh in bf16.
inline bool streams_ok(int streams)
{
    return streams == 0
        || ((streams & STREAM_RES_BF16) && (streams & ~STREAM_ALL) == 0);
}

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = GRU over x [T, B, D]; gx [T, B, 3H] is caller-allocated
// f32 scratch and holds x iW^T + b on return; swt = sW^T [H, 3H].  With gh
// non-null (emit_residuals) also gh [T, B, 3H], and from the bf16
// instance gx in bf16 into gxr [T, B, 3H] (the f32 instance's residual gx
// is the scratch).  `streams` (STREAM_* bits): 0 for all f32, else the
// bf16 instance (STREAM_RES_BF16: gh and gxr bf16), with x and h in bf16
// where their bits say.  The recurrence runs on the plan (instance, C,
// BT, RB, KS, smem) of ops/rnn_plan.py `rec_plan`: instance 0 the L2
// kernel (C 1, BT 8, RB 1, KS 1), 1 the cluster kernel; the input product
// on the GEMM plan gemm[0] of ops/gemm.py `gemm_plan`; a plan it cannot
// take returns cudaErrorInvalidValue before any launch.  Contiguous, on
// one device.  Returns cudaGetLastError() after the first failing launch
// (or the cluster launch's own error), else 0.
int tt_gru_fwd(const void* x, const float* iW, const float* b,
               const float* swt, float* gx, void* h, void* gh, void* gxr,
               int T, int B, int D, int H, int reverse, int streams,
               int instance, int C, int BT, int RB, int KS, int smem,
               const int* gemm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B;
    if (M == 0) return 0;
    const bool res16 = streams & STREAM_RES_BF16;
    if (H > REC_MAX_THREADS || !streams_ok(streams)
            || (streams & STREAM_DH_BF16)
            || (res16 && gh != nullptr && gxr == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const GemmIn xin{x, (streams & STREAM_X_BF16) != 0};
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 0), xin, iW, D);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gemm_gate(gemm_plan_at(gemm, 0), xin, iW, b, GemmOut{gx, false}, M,
                    3 * H, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (res16)
        return launch_gru_rec_plan<true>(
            gx, swt, h, gh, gxr, T, B, H, reverse,
            (streams & STREAM_H_BF16) != 0, instance, C, BT, RB, KS, smem,
            st);
    return launch_gru_rec_plan<false>(gx, swt, h, gh, nullptr, T, B, H,
                                      reverse, 0, instance, C, BT, RB, KS,
                                      smem, st);
}

// How many clusters of the cluster instance's plan (C ranks, BT rows a
// tile, RB a lane, KS k slices, smem bytes) for H units the card runs at
// once (cudaOccupancyMaxActiveClusters; 0 if none fits), or minus the
// CUDA error.
int tt_gru_cluster_occupancy(int H, int C, int BT, int RB, int KS, int smem)
{
    if (rec_cluster_check(H, C, BT, RB, KS, smem) != cudaSuccess)
        return -static_cast<int>(cudaErrorInvalidValue);
    const int threads = rec_cluster_threads((H + C - 1) / C, BT, RB, KS);
    return rec_with_rb(RB, [&](auto rb) {
        return rec_cluster_occupancy(
            gru_rec_cluster_kernel<decltype(rb)::value, false>, C, threads,
            smem);
    });
}

// GRU layer backward recomputing both gate streams.  Inputs: dh, h
// [T, B, H], x [T, B, D], iW [3H, D], b [3H], sw = sW [3H, H], iwt = iW^T
// [D, 3H].  Scratch: g_x, g_h [T, B, 3H] f32 (gx and gh, then dgx and dgh
// over them).  Outputs: dx [T, B, D] (x's type), dsw_part [nsplit, 3H, H],
// diw_part [nsplit, 3H, D], db_part [ceil(B/BT), 3H], the partials' counts
// those of their GEMM plans.  `streams`: x, h and dh bf16 where their bits
// say (no residuals: STREAM_RES_BF16 is refused); any of them takes the
// chain's bf16 instance on the f32 rebuilt streams.  The chain runs on the
// plan (instance, C, BT, RB, KL, smem) of ops/rnn_plan.py `bwd_plan`:
// instance 0 the L2 kernel (C 1, BT 8, RB 1, KL 1, 24 H BT bytes), 1 the
// cluster kernel; five GEMM plans (ops/gemm.py): gemm[0] x iW^T, gemm[1]
// h_prev sW^T (for T > 1, on (T - 1) B rows), then the chain's three; a
// plan it cannot take returns cudaErrorInvalidValue before any launch, and
// so does the bf16 instance on the cluster instance where its ring's fill
// takes no cp.async (a bf16 stream with H or U odd), or
// cudaErrorMisalignedAddress where a stream's base is not aligned to its
// copies (rec_ring_check; the wrappers copy such a view first).
int tt_gru_bwd(const void* dh, const void* h, const void* x,
               const float* iW, const float* b, const float* sw,
               const float* iwt, float* g_x, float* g_h, void* dx,
               float* dsw_part, float* diw_part, float* db_part, int T,
               int B, int D, int H, int reverse, int streams,
               const int* gemm, int instance, int C, int BT, int RB, int KL,
               int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B, H3 = 3 * H;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS
            || (streams & ~(STREAM_X_BF16 | STREAM_H_BF16 | STREAM_DH_BF16)))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool hb = streams & STREAM_H_BF16;
    const GemmIn xin{x, (streams & STREAM_X_BF16) != 0};
    const GemmIn hsrc{reverse ? advance(h, (size_t)B * H, hb) : h, hb};
    cudaError_t err = rec_bwd_plan_check(instance, 3, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && streams)
        err = rec_ring_check(instance, H, C,
                             {{dh, streams & STREAM_DH_BF16 ? 2 : 4},
                              {h, hb ? 2 : 4}, {g_x, 4}, {g_h, 4}});
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 0), xin, iW, D);
    if (err == cudaSuccess)
        err = gate_plan_check(gemm_plan_at(gemm, 1), hsrc, sw, H);
    if (err == cudaSuccess)
        err = chain_plans_check(gemm + 2 * GEMM_PLAN_INTS, g_x, g_h, iwt, xin,
                                GemmIn{h, hb}, M, H3, D, H);
    if (err != cudaSuccess) return static_cast<int>(err);

    // gx = x iW^T + b and gh[t] = h_prev[t] sW^T, h_prev[t] = h[t -/+ 1],
    // zero at the boundary step (f32 scratch in either instance)
    err = gemm_gate(gemm_plan_at(gemm, 0), xin, iW, b, GemmOut{g_x, false},
                    M, H3, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t step = (size_t)B * H3;
    float* gh_zero = reverse ? g_h + (size_t)(T - 1) * step : g_h;
    if ((err = cudaMemsetAsync(gh_zero, 0, step * sizeof(float), st))
            != cudaSuccess)
        return static_cast<int>(err);
    if (T > 1) {
        float* gdst = reverse ? g_h : g_h + step;
        err = gemm_gate(gemm_plan_at(gemm, 1), hsrc, sw, nullptr,
                        GemmOut{gdst, false}, (T - 1) * B, H3, H, st);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int hshift = reverse ? 1 : -1;
    const int* g = gemm + 2 * GEMM_PLAN_INTS;
    if (streams)
        return gru_bwd_chain<float, true>(
            dh, h, hshift, g_x, g_h, g_x, g_h, x, sw, iwt, dx, dsw_part,
            diw_part, db_part, T, B, D, H, reverse, streams, g, instance, C,
            BT, RB, KL, smem, st);
    return gru_bwd_chain<float, false>(
        dh, h, hshift, g_x, g_h, g_x, g_h, x, sw, iwt, dx, dsw_part,
        diw_part, db_part, T, B, D, H, reverse, 0, g, instance, C, BT, RB,
        KL, smem, st);
}

// GRU layer backward from the forward's gate streams.  Inputs: dh, hprev
// [T, B, H], gx, gh [T, B, 3H] (read only), x [T, B, D], sw = sW [3H, H],
// iwt = iW^T [D, 3H].  Scratch: dgx, dgh [T, B, 3H] f32.  Outputs and
// plan as tt_gru_bwd's; the chain's three GEMM plans gemm[0..2].
// `streams` as tt_gru_fwd's, with dh's bit: the bf16 instance reads gx
// and gh in bf16.
int tt_gru_bwd_fusedw(const void* dh, const void* gx, const void* gh,
                      const void* hprev, const void* x, const float* sw,
                      const float* iwt, float* dgx, float* dgh, void* dx,
                      float* dsw_part, float* diw_part, float* db_part,
                      int T, int B, int D, int H, int reverse, int streams,
                      const int* gemm, int instance, int C, int BT, int RB,
                      int KL, int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || !streams_ok(streams))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_bwd_plan_check(instance, 3, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && (streams & STREAM_RES_BF16))
        err = rec_ring_check(instance, H, C,
                             {{dh, streams & STREAM_DH_BF16 ? 2 : 4},
                              {hprev, streams & STREAM_H_BF16 ? 2 : 4},
                              {gx, 2}, {gh, 2}});
    if (err == cudaSuccess)
        err = chain_plans_check(
            gemm, dgx, dgh, iwt, GemmIn{x, (streams & STREAM_X_BF16) != 0},
            GemmIn{hprev, (streams & STREAM_H_BF16) != 0}, T * B, 3 * H, D,
            H);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (streams & STREAM_RES_BF16)
        return gru_bwd_chain<bf16, true>(
            dh, hprev, 0, static_cast<const bf16*>(gx),
            static_cast<const bf16*>(gh), dgx, dgh, x, sw, iwt, dx, dsw_part,
            diw_part, db_part, T, B, D, H, reverse, streams, gemm, instance,
            C, BT, RB, KL, smem, st);
    return gru_bwd_chain<float, false>(
        dh, hprev, 0, static_cast<const float*>(gx),
        static_cast<const float*>(gh), dgx, dgh, x, sw, iwt, dx, dsw_part,
        diw_part, db_part, T, B, D, H, reverse, 0, gemm, instance, C, BT, RB,
        KL, smem, st);
}

// Kernel 16: the GRU recurrence on given gates.  gx [T, B, 3H] (read
// only), swt = sW^T [H, 3H] -> h [T, B, H] (f32); with gh non-null also gh
// [T, B, 3H] = h_prev . sW^T.  `streams` (STREAM_* bits): 0 for all f32,
// or the bf16 instance (STREAM_RES_BF16: gh stored in bf16), whose gx is
// bf16 where STREAM_X_BF16 says (read through registers,
// rec_cluster.cuh); h stays f32 in both, and neither copies gx (the
// caller keeps it as the backward's residual).  The plan as tt_gru_fwd's.
// Returns cudaGetLastError().
int tt_gru_scan_fwd(const void* gx, const float* swt, float* h, void* gh,
                    int T, int B, int H, int reverse, int streams,
                    int instance, int C, int BT, int RB, int KS, int smem,
                    void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    const bool res16 = streams & STREAM_RES_BF16;
    const bool gx16 = streams & STREAM_X_BF16;
    if (H > REC_MAX_THREADS
            || (streams & ~(STREAM_X_BF16 | STREAM_RES_BF16))
            || (gx16 && !res16))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (gx16)
        return launch_gru_rec_plan<true, true>(gx, swt, h, gh, nullptr, T, B,
                                               H, reverse, 0, instance, C,
                                               BT, RB, KS, smem, st);
    if (res16)
        return launch_gru_rec_plan<true>(gx, swt, h, gh, nullptr, T, B, H,
                                         reverse, 0, instance, C, BT, RB, KS,
                                         smem, st);
    return launch_gru_rec_plan<false>(gx, swt, h, gh, nullptr, T, B, H,
                                      reverse, 0, instance, C, BT, RB, KS,
                                      smem, st);
}

// Kernel 17: the GRU gradient chain on the forward's residuals.  dh,
// hprev [T, B, H], gx, gh [T, B, 3H] (read only), sw = sW [3H, H] -> dgx,
// dgh [T, B, 3H]; db_part [ceil(B/BT), 3H] is scratch.  With iwt = iW^T
// [D, 3H] non-null also dx [T, B, D] (f32) = dgx . iW from the stored dgx,
// on the GEMM plan gemm[0].  `streams`: 0 for all f32, or the bf16
// instance (STREAM_RES_BF16: gh bf16), with
// gx, hprev and dh bf16 where STREAM_X_BF16, STREAM_H_BF16 and
// STREAM_DH_BF16 say, and dgx and dgh stored in dh's type (rounded where
// they are stored; the chain goes on from the f32 values).  The plan as tt_gru_bwd's.
int tt_gru_scan_bwd(const void* dh, const void* gx, const void* gh,
                    const void* hprev, const float* sw, const float* iwt,
                    void* dgx, void* dgh, float* dx, float* db_part, int T,
                    int B, int D, int H, int reverse, int streams,
                    int instance, int C, int BT, int RB, int KL, int smem,
                    const int* gemm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    const bool res16 = streams & STREAM_RES_BF16;
    const int d16 = (streams & STREAM_DH_BF16) != 0;
    if (H > REC_MAX_THREADS || (streams & ~STREAM_ALL)
            || (streams && !res16))
        return static_cast<int>(cudaErrorInvalidValue);
    const GemmIn dsrc{dgx, d16 != 0};
    cudaError_t err = rec_bwd_plan_check(instance, 3, H, C, BT, RB, KL, smem,
                                         REC_BT, REC_MAX_THREADS);
    if (err == cudaSuccess && res16)
        err = rec_ring_check(instance, H, C,
                             {{dh, d16 ? 2 : 4},
                              {hprev, streams & STREAM_H_BF16 ? 2 : 4},
                              {gx, streams & STREAM_X_BF16 ? 2 : 4},
                              {gh, 2}});
    if (err == cudaSuccess && iwt != nullptr)
        err = gate_plan_check(gemm_plan_at(gemm, 0), dsrc, iwt, 3 * H);
    if (err != cudaSuccess) return static_cast<int>(err);
    int rc;
    if (res16)
        rc = launch_gru_bwd_rec_plan<bf16, true>(
            dh, hprev, 0, gx, static_cast<const bf16*>(gh), dgx, dgh, sw,
            db_part, T, B, H, reverse, d16,
            (streams & STREAM_H_BF16) != 0, (streams & STREAM_X_BF16) != 0,
            d16, instance, C, BT, RB, KL, smem, st);
    else
        rc = launch_gru_bwd_rec_plan<float, false>(
            dh, hprev, 0, gx, static_cast<const float*>(gh), dgx, dgh, sw,
            db_part, T, B, H, reverse, 0, 0, 0, 0, instance, C, BT, RB, KL,
            smem, st);
    if (rc || iwt == nullptr) return rc;
    return static_cast<int>(gemm_gate(gemm_plan_at(gemm, 0), dsrc, iwt,
                                      nullptr, GemmOut{dx, false}, T * B, D,
                                      3 * H, st));
}

}  // extern "C"
