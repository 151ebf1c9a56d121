// Phase timing of the cluster instances' steps (csrc/rec_cluster.cuh) on
// the card: the layers' own cluster kernels instantiated with their phase
// clock (RecClock<true>), so that what is timed is the kernel the layers
// run.  Built twice, from the root of a checkout on the H100: as it is, it
// times the LSTM's forward (lstm_rec_cluster_kernel, emit mode h) and
// backward chain (lstm_bwd_rec_cluster_kernel, from acts); with
// -DPROBE_GRU, the GRU's backward chain (gru_bwd_rec_cluster_kernel):
//
//     mkdir -p taiyaki_tpu_torch/_build && for v in LSTM GRU; do \
//         nvcc -std=c++17 -O3 -gencode arch=compute_90a,code=sm_90a \
//         -DPROBE_$v probes/rec_phases.cu \
//         -o taiyaki_tpu_torch/_build/rec_phases_$v \
//         && taiyaki_tpu_torch/_build/rec_phases_$v; done
//
// It prints, per plan, the kernel's time (CUDA events, mean of 3 launches
// after one warm-up, T = 1000 steps) and the mean cycles a step of a CTA's
// thread 0 in each phase.  Forward: the top of the step (its gate
// copies), the product (with its __syncthreads), the cells, the send
// (fence, barrier, bulk copies) and the wait for the step's h.  Backward:
// the top (the wait for the step's ring copies), the cells (with the sum
// of the C partials), the product (with the barrier before it and the
// next step's copies), the send and the wait for the partials.  The
// weights and inputs are zero: the timing does not depend on the values.
// The plans are those ops/rnn_plan.py picks for the repo's shapes on an
// H100 SXM, each with the runner-up the plan's cost model weighed (the
// forward C = 1 at H = 96; the backward one output unit a lane, KL = 1,
// and at H = 96 another RB).

#include <stdio.h>

#include <vector>

#ifdef PROBE_GRU
#include "../taiyaki_tpu_torch/csrc/gru.cu"
#else
#include "../taiyaki_tpu_torch/csrc/lstm.cu"
#endif

namespace {

constexpr int T = 1000, BMAX = 341, HMAX = 384;

// the mean cycles a step of each phase over the CTAs, and the line
void report(const char* what, int H, int B, int C, int BT, int RB, int KS,
            int rc, float ms, int n, const long long* cyc,
            const char* const (&names)[REC_PHASES], const int (&order)[5])
{
    std::vector<long long> v(REC_PHASES * n);
    cudaMemcpy(v.data(), cyc, sizeof(long long) * v.size(),
               cudaMemcpyDeviceToHost);
    double mean[REC_PHASES] = {0, 0, 0, 0, 0};
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < REC_PHASES; ++j)
            mean[j] += (double)v[REC_PHASES * i + j] / n / T;
    printf("%-30s H=%d B=%d C=%d BT=%d RB=%d KS=%d: rc %d, %.3f ms (%.3f "
           "us a step); cycles a step:", what, H, B, C, BT, RB, KS, rc, ms,
           1e3 * ms / T);
    for (int j : order) printf(" %s %.0f", names[j], mean[j]);
    printf("\n");
}

// mean ms of 3 launches after one warm-up; rc the launches' error codes
template <typename F>
float time_launches(F launch, int* rc)
{
    *rc = launch();
    cudaDeviceSynchronize();
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    for (int i = 0; i < 3; ++i) *rc |= launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / 3;
}

const char* const FWD_NAMES[REC_PHASES] = {"top", "product", "cells", "send",
                                           "h wait"};
const char* const BWD_NAMES[REC_PHASES] = {"ring wait", "product", "cells",
                                           "send", "partials wait"};
constexpr int FWD_ORDER[5] = {REC_TOP, REC_PRODUCT, REC_CELLS, REC_SEND,
                              REC_WAIT};
constexpr int BWD_ORDER[5] = {REC_TOP, REC_CELLS, REC_PRODUCT, REC_SEND,
                              REC_WAIT};

#ifndef PROBE_GRU
template <int RB>
void run(const char* what, int B, int H, int C, int BT, int KS,
         const float* in, float* out, long long* cyc)
{
    const auto kernel = lstm_rec_cluster_kernel<RB, EMIT_H, true>;
    const int U = (H + C - 1) / C;
    const int threads = rec_cluster_threads(U, BT, RB, KS);
    const int smem = (int)rec_cluster_smem(H, C, U, BT, KS);
    const int ntiles = (B + BT - 1) / BT;
    int rc;
    const float ms = time_launches([&]() {
        return rec_cluster_launch(
            kernel, C, ntiles, threads, smem, nullptr, in, in, out,
            static_cast<float*>(nullptr), static_cast<float*>(nullptr),
            static_cast<float*>(nullptr), T, B, H, 0, C, U, BT, KS, cyc, 0);
    }, &rc);
    report(what, H, B, C, BT, RB, KS, rc, ms, C * ntiles, cyc, FWD_NAMES,
           FWD_ORDER);
}
#endif

// The backward chain's cluster kernel of the cell this probe was built
// for, on a plan of C ranks, BT rows a tile, RB rows and KL output units a
// lane.
template <int RB, int KL>
void run_bwd(const char* what, int B, int H, int C, int BT, const float* in,
             float* out, float* db, long long* cyc)
{
#ifdef PROBE_GRU
    const int G = 3;
    const auto kernel = gru_bwd_rec_cluster_kernel<RB, KL, true>;
#else
    const int G = 4;
    const auto kernel = lstm_bwd_rec_cluster_kernel<RB, KL, false, true>;
#endif
    const int U = (H + C - 1) / C;
    const int threads = rec_bwd_threads(H, BT, RB, KL);
    const int smem = (int)rec_bwd_smem(G, H, C, U, BT);
    const int ntiles = (B + BT - 1) / BT;
    int rc;
    const float ms = time_launches([&]() {
#ifdef PROBE_GRU
        return rec_cluster_launch(kernel, C, ntiles, threads, smem, nullptr,
                                  in, in, 0, in, in, out, out, in, db, T, B,
                                  H, 0, C, U, BT, cyc, 0, 0, 0, 0);
#else
        return rec_cluster_launch(kernel, C, ntiles, threads, smem, nullptr,
                                  in, in, in, in, 0, in, out, db, T, B, H,
                                  0, C, U, BT, cyc, 0, 0);
#endif
    }, &rc);
    report(what, H, B, C, BT, RB, KL, rc, ms, C * ntiles, cyc, BWD_NAMES,
           BWD_ORDER);
}

}  // namespace

int main()
{
    const size_t n = (size_t)T * BMAX * 4 * HMAX;
    float *in, *out, *db;
    long long* cyc;
    cudaMalloc(&in, sizeof(float) * n);
    cudaMalloc(&out, sizeof(float) * n);
    cudaMalloc(&db, sizeof(float) * BMAX * 4 * HMAX);
    cudaMalloc(&cyc, sizeof(long long) * REC_PHASES * 4096);
    cudaMemset(in, 0, sizeof(float) * n);
    setvbuf(stdout, nullptr, _IONBF, 0);
    int clk;
    cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
    printf("SM clock (maximum) %d kHz\n", clk);
#ifdef PROBE_GRU
    run_bwd<6, 2>("gru bwd, training, H=256", 256, 256, 8, 18, in, out, db,
                  cyc);
    run_bwd<9, 1>("  KL=1 instead", 256, 256, 8, 18, in, out, db, cyc);
    run_bwd<2, 1>("gru bwd, H=96", 256, 96, 2, 4, in, out, db, cyc);
    run_bwd<1, 1>("  RB=1 instead", 256, 96, 2, 4, in, out, db, cyc);
    run_bwd<5, 2>("gru bwd, H=384, 341 rows", 341, 384, 16, 10, in, out, db,
                  cyc);
#else
    run<9>("basecall, H=256", 128, 256, 8, 9, 12, in, out, cyc);
    run<6>("training, H=256", 256, 256, 8, 18, 4, in, out, cyc);
    run<2>("basecall, H=96", 128, 96, 2, 2, 4, in, out, cyc);
    run<1>("  C=1 instead", 128, 96, 1, 1, 4, in, out, cyc);
    run<9>("defaults, H=384, 341 rows", 341, 384, 16, 18, 2, in, out, cyc);
    run<5>("defaults, H=384, 128 rows", 128, 384, 16, 20, 1, in, out, cyc);
    run_bwd<9, 2>("lstm bwd, training, H=256", 256, 256, 8, 18, in, out, db,
                  cyc);
    run_bwd<9, 1>("  KL=1 instead", 256, 256, 8, 18, in, out, db, cyc);
    run_bwd<2, 1>("lstm bwd, H=96", 256, 96, 2, 4, in, out, db, cyc);
    run_bwd<5, 2>("lstm bwd, H=384, 341 rows", 341, 384, 16, 10, in, out, db,
                  cyc);
    run_bwd<9, 1>("  BT=9, KL=1 instead", 341, 384, 16, 9, in, out, db, cyc);
    run_bwd<5, 2>("lstm bwd, H=384, 128 rows", 128, 384, 16, 10, in, out, db,
                  cyc);
#endif
    printf("%s\n", cudaGetErrorString(cudaGetLastError()));
    return 0;
}
