// The tensor-core instance of the two f32 GEMMs of gemm.cuh, for Hopper
// (sm_90a): 3xTF32 on wgmma, its operands brought by TMA.  It computes
// the functions of gate_gemm_kernel and atb_gemm_kernel (gemm.cuh), which
// stay as the "simt" instance for shapes TMA cannot take; ops/gemm.py
// `gemm_plan` picks one of the two by shape before any launch.
//
//   kind TC_GATE: C[M, N] = A[M, K] . W[N, K]^T (+ bias[N]) (+ the C it
//     finds, with ACCUMULATE).  Both operands are K-major as they lie.
//   kind TC_ATB:  C_z[N1, N2] = sum over rows k of slice z of
//     A[k, :]^T B[k + shift, :], rows of B outside [0, K) read as zero.
//     Both operands are MN-major as they lie; slice z is the rows
//     [z kslice, min(K, (z + 1) kslice)), kslice a multiple of TC_BK, so
//     that no k tile straddles two slices, and every partial is one CTA's
//     sum in a fixed order: runs repeat bit for bit.
//
// Bound: operations.  3 x 2MNK FLOP at the 495 TFLOP/s TF32 rate (the
// three passes below), against 2MNK at 67 TFLOP/s for the f32 SIMT
// kernels; at the repo's shapes the bytes (each operand read once, C
// written once, 3.35 TB/s) are below both but at H = 96.
//
// Precision.  wgmma takes TF32 operands (10 stored mantissa bits) and no
// f32 ones.  Each f32 value x is split as big = rna_tf32(x) and small =
// rna_tf32(x - big), and C += A_small W_big + A_big W_small + A_big W_big
// (small terms first, as CUTLASS's 3xTF32): only A_small W_small, about
// 2^-22 of a product, is dropped, close to f32.  The tensor cores add a
// chain of products in a narrower way than fmaf's round-to-nearest; with
// PROMOTE each k tile's 12 products go into a fresh register sum that is
// added to the f32 sum by FADD, so no chain is longer than one k tile.
//
// Design.  A persistent grid (the plan's CTAs, at most one per SM) walks
// the output tiles of TC_BM x TC_BN, N fastest, so that the CTAs running
// at one time share the rows of A in L2.  A CTA is 3 warpgroups:
//   - warpgroup 2, the producer: one thread keeps a ring of TC_STAGES stages
//     filled by TMA (128-byte swizzle, zero fill outside the tensor,
//     negative coordinates included: the shift of TC_ATB), each stage
//     completing on its `full` mbarrier, and waits on its `empty`
//     mbarrier before refilling it;
//   - warps 0-7, two consumer warpgroups, each 64 rows of the tile.  For
//     every stage they split B into big and small, K-major, in buffers of
//     their own (TC_GATE: the same swizzled positions; TC_ATB: transposed
//     from the [k][n] boxes TMA brings), fence them to the async proxy and
//     meet at a named barrier; then each loads its A fragments from the
//     stage into registers, splitting them there (TC_ATB's transpose costs
//     nothing: a register fragment takes any layout; two register sets,
//     so that a k tile's loads overlap the previous k tile's wgmma), and
//     issues 4 k steps x 3 passes of wgmma m64n128k8 (A from registers, B
//     from the swizzled buffers by descriptor).  The next stage's split
//     overlaps this stage's wgmma; the stage is released once they
//     complete.  The epilogue (bias, ACCUMULATE; 8-byte stores of column
//     pairs) stores from registers while the producer already loads the
//     next tile.
// Shared memory: TC_STAGES x (A, B as loaded, B big, B small) of 16 KB =
// 192 KB, one CTA an SM.
//
// bf16 operands (the bf16 streams of the LSTM layers, ops/rnn.py).  The
// operand that a layer can hold in bf16 (TC_GATE's A: x or h_prev;
// TC_ATB's B: x or h) may come as bf16: TMA brings its tile as it lies,
// 2-byte elements with no swizzle (TC_GATE: [128 rows][32 k]; TC_ATB: one
// box [32 k][128 n]), and the consumers widen each value as they read it.
// A bf16 value is exact in TF32, so its small part is zero and the pass
// that multiplies it goes: two passes instead of three, the same products.
// TC_GATE may also write its output in bf16 (d_x of a bf16 layer input):
// the f32 sum rounded to nearest even once, in the epilogue.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// whether T is the 2-byte stream type
template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// v stored as a T: itself, or rounded to the nearest bf16 (ties to even)
template <typename T>
__device__ __forceinline__ T narrow(float v)
{
    if constexpr (is_bf16<T>) return __float2bfloat16_rn(v);
    else return v;
}

constexpr int TC_GATE = 0;
constexpr int TC_ATB = 1;
constexpr int TC_BM = 128;          // rows of a tile: 2 warpgroups of 64
constexpr int TC_BN = 128;          // columns of a tile: wgmma N
constexpr int TC_BK = 32;           // k a stage: one 128-byte swizzle row
constexpr int TC_STAGES = 3;
constexpr int TC_CONSUMERS = 256;   // threads of the two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 128;   // and the producer's
// registers a thread: the producer warpgroup gives up all but 40 of the
// 168 the launch grants (65536 / 384), the consumers take 232, which holds
// their two accumulators (128), A's fragments in two sets (64) and the
// rest unspilled
constexpr int TC_PRODUCER_REGS = 40;
constexpr int TC_CONSUMER_REGS = 232;
constexpr int TC_TILE = TC_BM * TC_BK * 4;     // bytes of one operand tile
constexpr int TC_STAGE = 4 * TC_TILE;          // A, B, B big, B small
constexpr size_t TC_SMEM = (size_t)TC_STAGES * TC_STAGE + 1024 + 64;
static_assert(TC_BM == TC_BN, "the operand tiles share one size");

__device__ __forceinline__ uint32_t tc_smem(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void tc_bar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(tc_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void tc_bar_expect(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(tc_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tc_bar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(tc_smem(bar)) : "memory");
}

// waits for the phase of parity `parity` of `bar` to complete; a wait
// past TC_WAIT_CYCLES (about 2 s) can only be a fault of the protocol, and
// traps, so that the launch fails instead of hanging the card
constexpr long long TC_WAIT_CYCLES = 4000000000LL;

__device__ __forceinline__ void tc_bar_wait(uint64_t* bar, uint32_t parity)
{
    const uint32_t a = tc_smem(bar);
    uint32_t done;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
        if (!done && clock64() - t0 > TC_WAIT_CYCLES) __trap();
    } while (!done);
}

// a 2-D box of the tensor map at coordinates (inner c0, outer c1) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tc_tma_load(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        :: "r"(tc_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(tc_smem(bar)), "r"(c0), "r"(c1) : "memory");
}

// the TF32 value nearest x (ties away), as f32 bits with the low 13 zero
__device__ __forceinline__ uint32_t tc_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void tc_split(float x, uint32_t& big,
                                         uint32_t& small)
{
    big = tc_tf32(x);
    small = tc_tf32(x - __uint_as_float(big));
}

// wgmma descriptor of a K-major tile of 8-row groups of 128-byte rows with
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): start address,
// LBO 1 (unused by swizzled K-major layouts), SBO 1024 bytes
__device__ __forceinline__ uint64_t tc_desc(uint32_t saddr)
{
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
        | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void tc_wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void tc_wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void tc_wgmma_wait0()
{
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of d across the asm
// statements around it (the wgmma in flight writes d behind its back)
__device__ __forceinline__ void tc_pin(float (&d)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= a . B, m64n128k8, TF32 in, f32 out; a the warpgroup's A
// fragment in registers, B by descriptor; scale_d 0 overwrites d
__device__ __forceinline__ void tc_mma(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t desc, int scale_d)
{
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

// byte offset of element (row r, k) of a K-major [128][32] f32 tile with
// the 128-byte swizzle: 16-byte chunk k / 4 of row r sits at chunk
// (k / 4) ^ (r % 8)
__device__ __forceinline__ uint32_t tc_kmajor(int r, int k)
{
    return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

// byte offset of element (row r, k) of the transpose of an MN-major tile
// as TC_ATB's TMA brings it: four boxes [32 k][32 r] of 4 KB, each row of
// 128 bytes with the 128-byte swizzle
__device__ __forceinline__ uint32_t tc_mnmajor(int r, int k)
{
    return (r >> 5) * 4096 + k * 128 + (((((r & 31) >> 2) ^ k) & 7) << 4)
        + ((r & 3) << 2);
}

// The tile's position: its first row m0 and column n0 of the output, the
// output it goes to (TC_ATB: partial z), and its k range in k tiles.
struct TcTile {
    int m0, n0, kt0, nkt;
    size_t out;
};

template <int KIND>
__device__ __forceinline__ TcTile tc_tile(int t, int M, int N, int K,
                                          int kslice)
{
    const int nt = (N + TC_BN - 1) / TC_BN;
    const int mt = (M + TC_BM - 1) / TC_BM;
    TcTile x;
    int z = 0;
    if (KIND == TC_ATB) {
        z = t / (mt * nt);
        t -= z * mt * nt;
    }
    x.m0 = (t / nt) * TC_BM;
    x.n0 = (t % nt) * TC_BN;
    if (KIND == TC_ATB) {
        const int kbeg = z * kslice;
        const int kend = min(K, kbeg + kslice);
        x.kt0 = kbeg / TC_BK;
        x.nkt = kend > kbeg ? (kend - kbeg + TC_BK - 1) / TC_BK : 0;
        x.out = (size_t)z * M * N;
    } else {
        x.kt0 = 0;
        x.nkt = (K + TC_BK - 1) / TC_BK;
        x.out = 0;
    }
    return x;
}

// The epilogue of a consumer thread: element i of its accumulator is row
// m + 8 ((i / 2) % 2), column n + 8 (i / 4) + i % 2 of the output (m, n its
// first).  Where the tile's columns all lie inside an even N and the
// pointers allow, each pair of columns goes as one store of two elements
// from two row pointers (full 32-byte sectors a warp, for f32); else
// element by element.  A bf16 output (TO) takes each sum rounded once.
template <typename TO>
__device__ __forceinline__ float2 tc_load2(const TO* p)
{
    if constexpr (is_bf16<TO>)
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    else
        return *reinterpret_cast<const float2*>(p);
}

template <typename TO>
__device__ __forceinline__ void tc_store2(TO* p, float2 v)
{
    if constexpr (is_bf16<TO>)
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x,
                                                                      v.y);
    else
        *reinterpret_cast<float2*>(p) = v;
}

template <int KIND, bool ACCUMULATE, typename TO>
__device__ __forceinline__ void tc_epilogue(const float (&acc)[64],
                                            const float* __restrict__ bias,
                                            TO* __restrict__ out, int M,
                                            int N, int m, int n)
{
    const bool pairs = (N & 1) == 0 && n - (n & 7) + TC_BN <= N
        && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(TO) - 1)) == 0
        && (reinterpret_cast<uintptr_t>(bias) & 7) == 0;
    if (pairs) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (m + 8 * h >= M) continue;
            TO* row = out + (size_t)(m + 8 * h) * N + n;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                float2 v = make_float2(acc[4 * j + 2 * h],
                                       acc[4 * j + 2 * h + 1]);
                if (KIND == TC_GATE && bias != nullptr) {
                    const float2 b = *reinterpret_cast<const float2*>(
                        bias + n + 8 * j);
                    v.x += b.x;
                    v.y += b.y;
                }
                if (ACCUMULATE) {
                    const float2 c = tc_load2(row + 8 * j);
                    v.x += c.x;
                    v.y += c.y;
                }
                tc_store2(row + 8 * j, v);
            }
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int mi = m + 8 * ((i >> 1) & 1);
        const int ni = n + 8 * (i >> 2) + (i & 1);
        if (mi < M && ni < N) {
            float v = acc[i];
            if (KIND == TC_GATE && bias != nullptr) v += bias[ni];
            if (ACCUMULATE) v += widen(out[(size_t)mi * N + ni]);
            out[(size_t)mi * N + ni] = narrow<TO>(v);
        }
    }
}

// TA, TB: the operands' element types (bf16 only for TC_GATE's A and
// TC_ATB's B, never both); TO: the output's (bf16 only for TC_GATE)
template <int KIND, bool ACCUMULATE, bool PROMOTE, typename TA = float,
          typename TB = float, typename TO = float>
__global__ void __launch_bounds__(TC_THREADS, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap mapA,
               const __grid_constant__ CUtensorMap mapB,
               const float* __restrict__ bias, TO* __restrict__ C, int M,
               int N, int K, int shift, int kslice, int ntiles)
{
    constexpr bool A_EXACT = is_bf16<TA>;   // small part zero: no pass
    constexpr bool B_EXACT = is_bf16<TB>;
    static_assert(!A_EXACT || KIND == TC_GATE, "bf16 A: TC_GATE only");
    static_assert(!B_EXACT || KIND == TC_ATB, "bf16 B: TC_ATB only");
    static_assert(!is_bf16<TO> || (KIND == TC_GATE && !ACCUMULATE),
                  "bf16 output: TC_GATE without ACCUMULATE only");
    constexpr uint32_t TILE_BYTES = TC_BM * TC_BK * (sizeof(TA)
                                                     + sizeof(TB));
    extern __shared__ uint8_t tc_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~(uintptr_t)1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * TC_STAGE);
    uint64_t* empty = full + TC_STAGES;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < TC_STAGES; ++s) {
            tc_bar_init(&full[s], 1);
            tc_bar_init(&empty[s], TC_CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= TC_CONSUMERS) {
        // the producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(TC_PRODUCER_REGS));
        if (tid != TC_CONSUMERS) return;
        int stage = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const TcTile x = tc_tile<KIND>(t, M, N, K, kslice);
            for (int kt = x.kt0; kt < x.kt0 + x.nkt; ++kt) {
                tc_bar_wait(&empty[stage], phase ^ 1);
                uint8_t* st = smem + stage * TC_STAGE;
                tc_bar_expect(&full[stage], TILE_BYTES);
                const int k0 = kt * TC_BK;
                if (KIND == TC_GATE) {
                    tc_tma_load(st, &mapA, k0, x.m0, &full[stage]);
                    tc_tma_load(st + TC_TILE, &mapB, k0, x.n0, &full[stage]);
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        tc_tma_load(st + j * 4096, &mapA, x.m0 + 32 * j, k0,
                                    &full[stage]);
                    if constexpr (B_EXACT) {
                        tc_tma_load(st + TC_TILE, &mapB, x.n0, k0 + shift,
                                    &full[stage]);
                    } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            tc_tma_load(st + TC_TILE + j * 4096, &mapB,
                                        x.n0 + 32 * j, k0 + shift,
                                        &full[stage]);
                    }
                }
                if (++stage == TC_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // the consumers: warpgroup q takes rows 64 q .. 64 q + 63 of the tile;
    // a thread's fragment rows are r0 and r0 + 8, its k columns t and t + 4
    // of each k step of 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(TC_CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g;
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    float part[64];   // PROMOTE: one k tile's products
    uint32_t abig0[4][4], asmall0[4][4], abig1[4][4], asmall1[4][4];
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const TcTile x = tc_tile<KIND>(t, M, N, K, kslice);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        int prev = -1;
        // one k tile: its A fragments go to registers of their own while
        // the previous k tile's products still read the other set
        const auto step = [&](uint32_t (&abig)[4][4],
                              uint32_t (&asmall)[4][4]) {
            tc_bar_wait(&full[stage], phase);
            uint8_t* st = smem + stage * TC_STAGE;
            const uint8_t* braw = st + TC_TILE;
            uint8_t* bbig = st + 2 * TC_TILE;
            uint8_t* bsmall = st + 3 * TC_TILE;
            // B, split into big and small, K-major and swizzled (a bf16
            // B widened: its big part is itself, its small part zero)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = tid + TC_CONSUMERS * i;   // 16-byte chunk
                float v[4];
                uint32_t off;
                if (KIND == TC_GATE) {
                    off = c * 16;
                    const float4 f =
                        *reinterpret_cast<const float4*>(braw + off);
                    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
                } else {
                    const int n = c & (TC_BN - 1), kc = c >> 7;
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if constexpr (B_EXACT)
                            v[e] = widen(reinterpret_cast<const bf16*>(
                                braw)[(4 * kc + e) * TC_BN + n]);
                        else
                            v[e] = *reinterpret_cast<const float*>(
                                braw + tc_mnmajor(n, 4 * kc + e));
                    }
                    off = tc_kmajor(n, 4 * kc);
                }
                if constexpr (B_EXACT) {
                    *reinterpret_cast<uint4*>(bbig + off) = make_uint4(
                        __float_as_uint(v[0]), __float_as_uint(v[1]),
                        __float_as_uint(v[2]), __float_as_uint(v[3]));
                } else {
                    uint4 big, small;
                    tc_split(v[0], big.x, small.x);
                    tc_split(v[1], big.y, small.y);
                    tc_split(v[2], big.z, small.z);
                    tc_split(v[3], big.w, small.w);
                    *reinterpret_cast<uint4*>(bbig + off) = big;
                    *reinterpret_cast<uint4*>(bsmall + off) = small;
                }
            }
            // A's fragments, split in registers (a bf16 A: [128][32] as
            // it lies, widened)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = r0 + 8 * (e & 1);
                    const int k = 8 * s + t4 + 4 * (e >> 1);
                    if constexpr (A_EXACT) {
                        abig[s][e] = __float_as_uint(widen(
                            reinterpret_cast<const bf16*>(st)[r * TC_BK
                                                              + k]));
                    } else {
                        const float v = *reinterpret_cast<const float*>(
                            st + (KIND == TC_GATE ? tc_kmajor(r, k)
                                                  : tc_mnmajor(r, k)));
                        tc_split(v, abig[s][e], asmall[s][e]);
                    }
                }
            }
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            asm volatile("bar.sync 1, %0;" :: "n"(TC_CONSUMERS) : "memory");
            // the previous stage's products are done: release it
            tc_wgmma_wait0();
            if constexpr (PROMOTE) {
                tc_pin(part);
                if (prev >= 0) {
#pragma unroll
                    for (int i = 0; i < 64; ++i) acc[i] += part[i];
                }
            }
            if (prev >= 0) tc_bar_arrive(&empty[prev]);
            const uint32_t big0 = tc_smem(bbig), small0 = tc_smem(bsmall);
            tc_wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                // k step s starts 32 bytes into each 128-byte row
                const uint64_t db = tc_desc(big0 + 32 * s);
                const uint64_t ds = tc_desc(small0 + 32 * s);
                // a bf16 operand's small part is zero: its pass goes (the
                // k tile's first pass overwrites part under PROMOTE)
                if constexpr (PROMOTE) {
                    if constexpr (!A_EXACT)
                        tc_mma(part, asmall[s], db, s > 0);
                    if constexpr (!B_EXACT)
                        tc_mma(part, abig[s], ds, A_EXACT ? s > 0 : 1);
                    tc_mma(part, abig[s], db, 1);
                } else {
                    if constexpr (!A_EXACT) tc_mma(acc, asmall[s], db, 1);
                    if constexpr (!B_EXACT) tc_mma(acc, abig[s], ds, 1);
                    tc_mma(acc, abig[s], db, 1);
                }
            }
            tc_wgmma_commit();
            prev = stage;
            if (++stage == TC_STAGES) {
                stage = 0;
                phase ^= 1;
            }
        };
        for (int kt = 0; kt < x.nkt; kt += 2) {
            step(abig0, asmall0);
            if (kt + 1 < x.nkt) step(abig1, asmall1);
        }
        tc_wgmma_wait0();
        if constexpr (PROMOTE) {
            tc_pin(part);
            if (prev >= 0) {
#pragma unroll
                for (int i = 0; i < 64; ++i) acc[i] += part[i];
            }
        } else {
            tc_pin(acc);
        }
        if (prev >= 0) tc_bar_arrive(&empty[prev]);

        tc_epilogue<KIND, ACCUMULATE>(acc, bias, C + x.out, M, N, x.m0 + r0,
                                      x.n0 + 2 * t4);
    }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*TcEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (the libraries are not linked
// against libcuda), or null
inline TcEncodeTiled tc_encode()
{
    static const TcEncodeTiled fn = []() -> TcEncodeTiled {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e != cudaSuccess || q != cudaDriverEntryPointSuccess)
            return nullptr;
        return reinterpret_cast<TcEncodeTiled>(p);
    }();
    return fn;
}

// the map of a row-major matrix [outer][inner] of T, boxes of box_inner x
// box_outer, zero outside it: f32 with the 128-byte swizzle, bf16 with none
template <typename T>
inline bool tc_map(CUtensorMap* map, const T* base, int inner, int outer,
                   int box_inner, int box_outer)
{
    const TcEncodeTiled enc = tc_encode();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
    const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
    const cuuint32_t unit[2] = {1, 1};
    return enc(map, is_bf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<T*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               is_bf16<T> ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int tc_tiles(int M, int N)
{
    return ((M + TC_BM - 1) / TC_BM) * ((N + TC_BN - 1) / TC_BN);
}

template <int KIND, bool ACCUMULATE, bool PROMOTE, typename TA, typename TB,
          typename TO>
cudaError_t tc_launch(const CUtensorMap& a, const CUtensorMap& b,
                      const float* bias, TO* C, int M, int N, int K,
                      int shift, int kslice, int ntiles, int ctas,
                      cudaStream_t st)
{
    const auto kernel = tc_gemm_kernel<KIND, ACCUMULATE, PROMOTE, TA, TB, TO>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<min(ctas, ntiles), TC_THREADS, TC_SMEM, st>>>(
        a, b, bias, C, M, N, K, shift, kslice, ntiles);
    return cudaGetLastError();
}

// C[M, N] = A[M, K] W[N, K]^T (+ bias) (+ C) on `ctas` persistent CTAs;
// A and W 16-byte aligned, rows of K a multiple of 16 bytes (TMA's row
// strides).  A may be bf16, or C (without accumulate), not both.
template <bool PROMOTE = true, typename TA = float, typename TO = float>
cudaError_t tc_gate_gemm(const TA* A, const float* W, const float* bias,
                         TO* C, int M, int N, int K, bool accumulate,
                         int ctas, cudaStream_t st)
{
    static_assert(!(is_bf16<TA> && is_bf16<TO>), "one bf16 side at most");
    if (M <= 0 || N <= 0) return cudaSuccess;
    CUtensorMap a, b;
    if (!tc_map(&a, A, K, M, TC_BK, TC_BM) || !tc_map(&b, W, K, N, TC_BK,
                                                      TC_BN))
        return cudaErrorInvalidValue;
    const int ntiles = tc_tiles(M, N);
    if constexpr (is_bf16<TO>) {
        if (accumulate) return cudaErrorInvalidValue;
        return tc_launch<TC_GATE, false, PROMOTE, TA, float, TO>(
            a, b, bias, C, M, N, K, 0, 0, ntiles, ctas, st);
    } else {
        return accumulate
            ? tc_launch<TC_GATE, true, PROMOTE, TA, float, TO>(
                  a, b, bias, C, M, N, K, 0, 0, ntiles, ctas, st)
            : tc_launch<TC_GATE, false, PROMOTE, TA, float, TO>(
                  a, b, bias, C, M, N, K, 0, 0, ntiles, ctas, st);
    }
}

// C[z, N1, N2] = the partial of slice z (kslice rows, a multiple of TC_BK)
// of A[K, N1]^T B[K + shift, N2], nsplit slices; rows of N1 and N2
// multiples of 16 bytes.  B may be bf16.
template <bool PROMOTE = true, typename TB = float>
cudaError_t tc_atb_gemm(const float* A, const TB* B, float* C, int K,
                        int N1, int N2, int shift, int nsplit, int kslice,
                        int ctas, cudaStream_t st)
{
    if (N1 <= 0 || N2 <= 0) return cudaSuccess;
    CUtensorMap a, b;
    if (!tc_map(&a, A, N1, K, 32, TC_BK)
            || !tc_map(&b, B, N2, K, is_bf16<TB> ? TC_BN : 32, TC_BK))
        return cudaErrorInvalidValue;
    const int ntiles = tc_tiles(N1, N2) * nsplit;
    return tc_launch<TC_ATB, false, PROMOTE, float, TB, float>(
        a, b, nullptr, C, N1, N2, K, shift, kslice, ntiles, ctas, st);
}

}  // namespace
