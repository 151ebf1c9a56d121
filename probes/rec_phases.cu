// Phase timing of the cluster instance's step (csrc/rec_cluster.cuh) on
// the card: the LSTM layer's own cluster kernel (lstm.cu,
// lstm_rec_cluster_kernel, emit mode h) instantiated with its phase clock
// (RecClock<true>), so that what is timed is the kernel the layers run.
// Build and run on the H100, from the root of a checkout:
//
//     mkdir -p taiyaki_tpu_torch/_build && nvcc -std=c++17 -O3 \
//         -gencode arch=compute_90a,code=sm_90a probes/rec_phases.cu \
//         -o taiyaki_tpu_torch/_build/rec_phases \
//         && taiyaki_tpu_torch/_build/rec_phases
//
// It prints, per plan, the kernel's time (CUDA events, mean of 3 launches
// after one warm-up, T = 1000 steps) and the mean cycles a step of a CTA's
// thread 0 in: the top of the step (its gate copies), the product (with
// its __syncthreads), the cells, the send (rec_send: fence, barrier, bulk
// copies) and the wait for the step's h.  The weights and gates are zero:
// the timing does not depend on the values.  The plans are those
// ops/rnn_plan.py picks for the repo's shapes on an H100 SXM, and C = 1 at
// H = 96 beside C = 2.

#include <stdio.h>

#include <vector>

#include "../taiyaki_tpu_torch/csrc/lstm.cu"

namespace {

template <int RB>
void run(const char* what, int T, int B, int H, int C, int BT, int KS,
         const float* gx, const float* swt, float* h, long long* cyc)
{
    const auto kernel = lstm_rec_cluster_kernel<RB, EMIT_H, true>;
    const int U = (H + C - 1) / C;
    const int threads = rec_cluster_threads(U, BT, RB, KS);
    const int smem = (int)rec_cluster_smem(H, C, U, BT, KS);
    const int ntiles = (B + BT - 1) / BT;
    auto launch = [&]() {
        return rec_cluster_launch(
            kernel, C, ntiles, threads, smem, nullptr, gx, swt, h,
            static_cast<float*>(nullptr), static_cast<float*>(nullptr),
            static_cast<float*>(nullptr), T, B, H, 0, C, U, BT, KS, cyc);
    };
    int rc = launch();
    cudaDeviceSynchronize();
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    for (int i = 0; i < 3; ++i) rc |= launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    ms /= 3;
    const int n = C * ntiles;
    std::vector<long long> v(REC_PHASES * n);
    cudaMemcpy(v.data(), cyc, sizeof(long long) * v.size(),
               cudaMemcpyDeviceToHost);
    double mean[REC_PHASES] = {0, 0, 0, 0, 0};
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < REC_PHASES; ++j)
            mean[j] += (double)v[REC_PHASES * i + j] / n / T;
    printf("%-28s H=%d B=%d C=%d BT=%d RB=%d KS=%d: rc %d, %.3f ms (%.3f "
           "us a step); cycles a step: top %.0f, product %.0f, cells %.0f, "
           "send %.0f, h wait %.0f\n", what, H, B, C, BT, RB, KS, rc, ms,
           1e3 * ms / T, mean[REC_TOP], mean[REC_PRODUCT], mean[REC_CELLS],
           mean[REC_SEND], mean[REC_WAIT]);
}

}  // namespace

int main()
{
    const int T = 1000, BMAX = 341, HMAX = 384;
    float *gx, *swt, *h;
    long long* cyc;
    cudaMalloc(&gx, sizeof(float) * T * BMAX * 4 * HMAX);
    cudaMalloc(&swt, sizeof(float) * HMAX * 4 * HMAX);
    cudaMalloc(&h, sizeof(float) * T * BMAX * HMAX);
    cudaMalloc(&cyc, sizeof(long long) * REC_PHASES * 4096);
    cudaMemset(gx, 0, sizeof(float) * T * BMAX * 4 * HMAX);
    cudaMemset(swt, 0, sizeof(float) * HMAX * 4 * HMAX);
    setvbuf(stdout, nullptr, _IONBF, 0);
    int clk;
    cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
    printf("SM clock (maximum) %d kHz\n", clk);
    run<9>("basecall, H=256", T, 128, 256, 8, 9, 12, gx, swt, h, cyc);
    run<6>("training, H=256", T, 256, 256, 8, 18, 4, gx, swt, h, cyc);
    run<2>("basecall, H=96", T, 128, 96, 2, 2, 4, gx, swt, h, cyc);
    run<1>("  C=1 instead", T, 128, 96, 1, 1, 4, gx, swt, h, cyc);
    run<9>("defaults, H=384, 341 rows", T, 341, 384, 16, 18, 2, gx, swt, h,
           cyc);
    run<5>("defaults, H=384, 128 rows", T, 128, 384, 16, 20, 1, gx, swt, h,
           cyc);
    printf("%s\n", cudaGetErrorString(cudaGetLastError()));
    return 0;
}
