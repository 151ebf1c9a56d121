// GRU layer forward and backwards for Hopper (sm_90a), f32.
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
// with gh beside it and the gx scratch kept as the output gx
// (emit_residuals=True), for the backward from stored gate streams.
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
//   its own), and with iW also d_x = dgx . iW by kernel 1, the product the
//   TPU kernel forms in its body (`_gru_bwd_dx_kernel`).
// Bound: the serial chain, as for the layer kernels (at T=2000, B=256,
// H=256 the operations bound is 3.0 ms and the bytes bound 1.1-2.2 ms,
// against tens of ms of chain).
//
// Kernels:
//
// 1. gate_gemm_kernel (gemm.cuh).  Forward: gx = x . iW^T + b [T, B, 3H],
//    which the TPU kernel computes per time block in its body.  Recomputing
//    backward: gx again, gh = h_prev . sW^T for all steps at once (the TPU
//    kernel forms it step by step inside its serial loop,
//    pallas_rnn.py:1264-1268; here h is wholly known before the backward
//    starts, so the product leaves the chain).  Both backwards, after the
//    chain: d_x = dgx . iW.  Bound: operations at the f32 rate.  The two
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
//    a. gru_rec_cluster_kernel<RB, RES> (the cluster instance, the plan's
//       choice wherever it fits, up to H ~ 450): a cluster of C CTAs per
//       tile of BT batch rows, rank q keeping the three gate rows of its
//       H/C units over all H inputs in shared memory for the whole launch
//       (as float4 with a zero fourth gate: 72 KB at the shipped remap
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
//    b. gru_rec_kernel<BT, RES> (the L2 instance, where the slice does not
//       fit: H = 512).  One block per tile of BT = 8 batch rows, one thread
//       per hidden unit j owning the gate rows j, H+j and 2H+j for the BT
//       rows (24 accumulators) and its h in registers; h of the tile lives
//       in shared memory, double-buffered so one barrier per step
//       suffices; every step reads sW^T again from L2 (coalesced: thread j
//       reads column j of each row).
//    With RES either stores the step's gh, a value it holds anyway.
//
// 3. gru_bwd_rec_kernel: the backward recurrence, walking opposite to the
//    forward.  It carries only dh: per step thread k reads gx, gh and
//    h_prev for unit k of its rows and forms
//        dz = dh (h_prev - n),  dn_pre = dh (1 - z)(1 - n^2),
//        dr_pre = dn_pre gh_n r (1 - r),  dz_pre = dz z (1 - z),
//        dgx = [dr_pre, dz_pre, dn_pre],  dgh = [dr_pre, dz_pre, dn_pre r],
//    (pallas_rnn.py:1120-1137), writes dgx and dgh, sums d_b per batch
//    tile in registers, puts dgh of the tile in shared memory
//    (double-buffered, 48 KB at H = 256) and forms
//        dh_prev[k] = sum_g dgh[g] sW[g, k] + dh z,
//    reading column k of sW (3H values) from L2.  Bound: the serial chain.
//    The recomputing backward passes its gx and gh scratch as dgx and dgh
//    too, so the gradients overwrite them and no third stream is needed;
//    the backward from stored streams must leave the forward's gx and gh
//    as they are (autograd keeps them, and a retained graph reads them
//    again) and writes to scratch of its own.  Every load of a step comes
//    before its first store, so either way is safe.  h_prev is read from a
//    stream at a time offset: h one step back in the forward's direction
//    (recompute) or h_prev itself (offset 0).
//
// 4. atb_gemm_kernel (gemm.cuh): d_iW = dgx^T x and d_sW = dgh^T h_prev as
//    split-K partials over slices of the T*B rows, h_prev read from h by
//    a -B (forward layer) or +B (reversed layer) row shift, or from
//    h_prev as it is.  The TPU kernels accumulate them in VMEM across
//    their sequential time grid; Hopper blocks carry nothing across blocks.
//
// Rows of the last batch tile past B run on zeros and are never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"
#include "rec_cluster.cuh"

namespace {

__device__ __forceinline__ float sigmoidf_(float x)
{
    return 1.f / (1.f + expf(-x));
}

constexpr int REC_BT = 8;          // batch rows per block
constexpr int REC_MAX_THREADS = 512;

// h[t, b, :] for the BT-row batch tile of this block; with RES also
// gh[t, b, :] = h_prev . sW^T.
// gx [T, B, 3H] (input gates incl. bias), swt [H, 3H] = sW^T, h [T, B, H],
// gh [T, B, 3H].
template <int BT, bool RES>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_rec_kernel(const float* __restrict__ gx, const float* __restrict__ swt,
               float* __restrict__ h_out, float* __restrict__ gh_out, int T,
               int B, int H, int reverse)
{
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
            const float* g = gx + row * H3 + j;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                float g0 = 0.f, g1 = 0.f, g2 = 0.f;
                if (r < nrow) {
                    const float* gr = g + (size_t)r * H3;
                    g0 = gr[0]; g1 = gr[H]; g2 = gr[2 * H];
                    if (RES) {
                        float* o = gh_out + (row + r) * H3 + j;
                        o[0] = acc[0][r]; o[H] = acc[1][r];
                        o[2 * H] = acc[2][r];
                    }
                }
                const float rg = sigmoidf_(g0 + acc[0][r]);
                const float zg = sigmoidf_(g1 + acc[1][r]);
                const float ng = tanhf(g2 + rg * acc[2][r]);
                const float h = (1.f - zg) * ng + zg * hr[r];
                hr[r] = h;
                hn[j * BT + r] = h;
                if (r < nrow) h_out[(row + r) * H + j] = h;
            }
        }
        __syncthreads();
    }
}

// The cluster instance of the forward recurrence: what gru_rec_kernel
// computes, for the tile of BT rows of this cluster, rank q holding units
// [q U, q U + U); the product in KS k slices of RB rows a lane
// (rec_cluster.cuh).  Arguments as gru_rec_kernel's; C ranks of U units.
template <int RB, bool RES>
__global__ void __launch_bounds__(REC_CLUSTER_THREADS, 1)
gru_rec_cluster_kernel(const float* __restrict__ gx,
                       const float* __restrict__ swt,
                       float* __restrict__ h_out, float* __restrict__ gh_out,
                       int T, int B, int H, int reverse, int C, int U, int BT,
                       int KS)
{
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
        rec_step_top<3>(m, gx, s, T, reverse ? t - 1 : t + 1, B, b0, nrow, H,
                        C, U, u0, BT, cl);
        if (works) rec_partials<3, RB>(m, hc, wk, U, BT);
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
                h_out[r * H + u] = h;
                if (RES) {
                    float* o = gh_out + r * H3 + u;
                    o[0] = gh.x; o[H] = gh.y; o[2 * H] = gh.z;
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

// Backward recurrence for the BT-row batch tile of this block.  dh [T, B,
// H] (gradient of the layer's output); h_prev of step t is hp[t + hshift]
// (zero outside [0, T)); gx, gh [T, B, 3H] the gate streams; dgx, dgh
// [T, B, 3H] their gradients, which may be gx and gh themselves; sw [3H, H]
// = sW; db_part [nbt, 3H] per-tile bias gradients.  No __restrict__ on the
// four streams, for the in-place case: every load of a step precedes its
// stores.
template <int BT>
__global__ void __launch_bounds__(REC_MAX_THREADS)
gru_bwd_rec_kernel(const float* __restrict__ dh_out,
                   const float* __restrict__ hp, int hshift, const float* gx,
                   const float* gh, float* dgx, float* dgh,
                   const float* __restrict__ sw, float* __restrict__ db_part,
                   int T, int B, int H, int reverse)
{
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
                    v[r][0] = gx[og]; v[r][1] = gx[og + H];
                    v[r][2] = gx[og + 2 * H];
                    v[r][3] = gh[og]; v[r][4] = gh[og + H];
                    v[r][5] = gh[og + 2 * H];
                    if (has_prev)
                        v[r][6] = hp[((size_t)tp * B + b0 + r) * H + k];
                    v[r][7] = dh_out[(row + r) * H + k];
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
                    dgx[og] = p[0];
                    dgx[og + H] = p[1];
                    dgx[og + 2 * H] = dn_pre;
                    dgh[og] = p[0];
                    dgh[og + H] = p[1];
                    dgh[og + 2 * H] = p[2];
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

template <bool RES>
int launch_gru_rec(const float* gx, const float* swt, float* h, float* gh,
                   int T, int B, int H, int reverse, cudaStream_t st)
{
    const size_t smem = 2 * sizeof(float) * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)gru_rec_kernel<REC_BT, RES>, smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    gru_rec_kernel<REC_BT, RES><<<blocks, threads, smem, st>>>(
        gx, swt, h, gh, T, B, H, reverse);
    return static_cast<int>(cudaGetLastError());
}

// The cluster instance (kernel 2a) on a plan of C ranks, BT rows a tile,
// RB rows a lane and KS k slices.
template <int RB, bool RES>
int launch_gru_rec_cluster(const float* gx, const float* swt, float* h,
                           float* gh, int T, int B, int H, int reverse, int C,
                           int BT, int KS, int smem, cudaStream_t st)
{
    const int U = (H + C - 1) / C;
    return rec_cluster_launch(gru_rec_cluster_kernel<RB, RES>, C,
                              (B + BT - 1) / BT,
                              rec_cluster_threads(U, BT, RB, KS), smem, st,
                              gx, swt, h, gh, T, B, H, reverse, C, U, BT, KS);
}

// Kernel 2 on a checked plan (rec_plan_check): the L2 or cluster instance.
template <bool RES>
int launch_gru_rec_plan_res(const float* gx, const float* swt, float* h,
                            float* gh, int T, int B, int H, int reverse,
                            int instance, int C, int BT, int RB, int KS,
                            int smem, cudaStream_t st)
{
    if (instance == INSTANCE_L2)
        return launch_gru_rec<RES>(gx, swt, h, gh, T, B, H, reverse, st);
    return rec_with_rb(RB, [&](auto rb) {
        return launch_gru_rec_cluster<decltype(rb)::value, RES>(
            gx, swt, h, gh, T, B, H, reverse, C, BT, KS, smem, st);
    });
}

// gh non-null stores the residual gh.
int launch_gru_rec_plan(const float* gx, const float* swt, float* h,
                        float* gh, int T, int B, int H, int reverse,
                        int instance, int C, int BT, int RB, int KS, int smem,
                        cudaStream_t st)
{
    if (gh != nullptr)
        return launch_gru_rec_plan_res<true>(gx, swt, h, gh, T, B, H,
                                             reverse, instance, C, BT, RB,
                                             KS, smem, st);
    return launch_gru_rec_plan_res<false>(gx, swt, h, nullptr, T, B, H,
                                          reverse, instance, C, BT, RB, KS,
                                          smem, st);
}

// The backward chain (kernel 3) alone: dgx, dgh and the per-tile d_b.
int launch_gru_bwd_rec(const float* dh, const float* hp, int hshift,
                       const float* gx, const float* gh, float* dgx,
                       float* dgh, const float* sw, float* db_part, int T,
                       int B, int H, int reverse, cudaStream_t st)
{
    const size_t smem = 2 * sizeof(float) * 3 * H * REC_BT;
    int rc;
    if ((rc = set_smem((const void*)gru_bwd_rec_kernel<REC_BT>, smem)))
        return rc;
    const int threads = (H + 31) / 32 * 32;
    const int blocks = (B + REC_BT - 1) / REC_BT;
    gru_bwd_rec_kernel<REC_BT><<<blocks, threads, smem, st>>>(
        dh, hp, hshift, gx, gh, dgx, dgh, sw, db_part, T, B, H, reverse);
    return static_cast<int>(cudaGetLastError());
}

// The chain (kernel 3) and the three products after it (d_x, d_iW, d_sW);
// h_prev of step t is hp[t + hshift].
int gru_bwd_chain(const float* dh, const float* hp, int hshift,
                  const float* gx, const float* gh, float* dgx, float* dgh,
                  const float* x, const float* sw, const float* iwt,
                  float* dx, float* dsw_part, float* diw_part, float* db_part,
                  int T, int B, int D, int H, int reverse, int nsplit,
                  cudaStream_t st)
{
    const int M = T * B, H3 = 3 * H;
    int rc = launch_gru_bwd_rec(dh, hp, hshift, gx, gh, dgx, dgh, sw,
                                db_part, T, B, H, reverse, st);
    if (rc) return rc;
    cudaError_t err;
    if ((err = launch_gate_gemm(dgx, iwt, nullptr, dx, M, D, H3, st))
            != cudaSuccess)
        return static_cast<int>(err);
    if ((err = launch_atb_gemm(dgx, x, diw_part, M, H3, D, 0, nsplit, st))
            != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(launch_atb_gemm(dgh, hp, dsw_part, M, H3, H,
                                            hshift * B, nsplit, st));
}

}  // namespace

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, B, H] = GRU over x [T, B, D]; gx [T, B, 3H] is caller-allocated
// and holds x iW^T + b on return; swt = sW^T [H, 3H].  With gh non-null
// (emit_residuals) also gh [T, B, 3H].  The recurrence runs on the plan
// (instance, C, BT, RB, KS, smem) of ops/rnn_plan.py `rec_plan`: instance
// 0 the L2 kernel (C 1, BT 8, RB 1, KS 1), 1 the cluster kernel; a plan it
// cannot take returns cudaErrorInvalidValue before any launch.  All f32,
// contiguous, on one device.  Returns cudaGetLastError() after the first
// failing launch (or the cluster launch's own error), else 0.
int tt_gru_fwd(const float* x, const float* iW, const float* b,
               const float* swt, float* gx, float* h, float* gh, int T,
               int B, int D, int H, int reverse, int instance, int C, int BT,
               int RB, int KS, int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_gate_gemm(x, iW, b, gx, M, 3 * H, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_gru_rec_plan(gx, swt, h, gh, T, B, H, reverse, instance, C,
                               BT, RB, KS, smem, st);
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
// [D, 3H].  Scratch: g_x, g_h [T, B, 3H] (gx and gh, then dgx and dgh over
// them).  Outputs: dx [T, B, D], dsw_part [nsplit, 3H, H], diw_part
// [nsplit, 3H, D], db_part [ceil(B/8), 3H].
int tt_gru_bwd(const float* dh, const float* h, const float* x,
               const float* iW, const float* b, const float* sw,
               const float* iwt, float* g_x, float* g_h,
               float* dx, float* dsw_part, float* diw_part, float* db_part,
               int T, int B, int D, int H, int reverse, int nsplit,
               void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int M = T * B, H3 = 3 * H;
    if (M == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);

    // gx = x iW^T + b and gh[t] = h_prev[t] sW^T, h_prev[t] = h[t -/+ 1],
    // zero at the boundary step
    cudaError_t err = launch_gate_gemm(x, iW, b, g_x, M, H3, D, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t step = (size_t)B * H3;
    float* gh_zero = reverse ? g_h + (size_t)(T - 1) * step : g_h;
    if ((err = cudaMemsetAsync(gh_zero, 0, step * sizeof(float), st))
            != cudaSuccess)
        return static_cast<int>(err);
    if (T > 1) {
        const float* hsrc = reverse ? h + (size_t)B * H : h;
        float* gdst = reverse ? g_h : g_h + step;
        err = launch_gate_gemm(hsrc, sw, nullptr, gdst, (T - 1) * B, H3, H,
                               st);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return gru_bwd_chain(dh, h, reverse ? 1 : -1, g_x, g_h, g_x, g_h, x, sw,
                         iwt, dx, dsw_part, diw_part, db_part, T, B, D, H,
                         reverse, nsplit, st);
}

// GRU layer backward from the forward's gate streams.  Inputs: dh, hprev
// [T, B, H], gx, gh [T, B, 3H] (read only), x [T, B, D], sw = sW [3H, H],
// iwt = iW^T [D, 3H].  Scratch: dgx, dgh [T, B, 3H].  Outputs as
// tt_gru_bwd's.
int tt_gru_bwd_fusedw(const float* dh, const float* gx, const float* gh,
                      const float* hprev, const float* x, const float* sw,
                      const float* iwt, float* dgx, float* dgh, float* dx,
                      float* dsw_part, float* diw_part, float* db_part,
                      int T, int B, int D, int H, int reverse, int nsplit,
                      void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS || nsplit < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return gru_bwd_chain(dh, hprev, 0, gx, gh, dgx, dgh, x, sw, iwt, dx,
                         dsw_part, diw_part, db_part, T, B, D, H, reverse,
                         nsplit, st);
}

// Kernel 16: the GRU recurrence on given gates.  gx [T, B, 3H] (read
// only), swt = sW^T [H, 3H] -> h [T, B, H]; with gh non-null also gh
// [T, B, 3H] = h_prev . sW^T.  The plan as tt_gru_fwd's.  Returns
// cudaGetLastError().
int tt_gru_scan_fwd(const float* gx, const float* swt, float* h, float* gh,
                    int T, int B, int H, int reverse, int instance, int C,
                    int BT, int RB, int KS, int smem, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = rec_plan_check(instance, H, C, BT, RB, KS, smem,
                                     REC_BT, REC_MAX_THREADS);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_gru_rec_plan(gx, swt, h, gh, T, B, H, reverse, instance, C,
                               BT, RB, KS, smem, st);
}

// Kernel 17: the GRU gradient chain on the forward's residuals.  dh,
// hprev [T, B, H], gx, gh [T, B, 3H] (read only), sw = sW [3H, H] -> dgx,
// dgh [T, B, 3H]; db_part [ceil(B/8), 3H] is scratch.  With iwt = iW^T
// [D, 3H] non-null also dx [T, B, D] = dgx . iW.
int tt_gru_scan_bwd(const float* dh, const float* gx, const float* gh,
                    const float* hprev, const float* sw, const float* iwt,
                    float* dgx, float* dgh, float* dx, float* db_part, int T,
                    int B, int D, int H, int reverse, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T * B == 0) return 0;
    if (H > REC_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    int rc = launch_gru_bwd_rec(dh, hprev, 0, gx, gh, dgx, dgh, sw, db_part,
                                T, B, H, reverse, st);
    if (rc || iwt == nullptr) return rc;
    return static_cast<int>(launch_gate_gemm(dgx, iwt, nullptr, dx, T * B,
                                             D, 3 * H, st));
}

}  // extern "C"
