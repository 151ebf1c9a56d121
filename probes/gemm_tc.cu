// Probe of the tc instance of csrc/gemm.cuh (csrc/gemm_tc.cuh) against the
// simt one: both GEMMs with and without PROMOTE (each k tile's products
// summed in registers of their own, then added to the f32 sum by FADD),
// so that probes/gemm_tc.py can measure what the tensor cores' chained
// accumulation costs in accuracy and in time.  Built by that script:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//         -Xcompiler -fPIC -o <lib> probes/gemm_tc.cu

#include <cuda_runtime.h>

#include "../taiyaki_tpu_torch/csrc/gemm.cuh"

extern "C" {

// variant 0: simt; 1: tc with PROMOTE; 2: tc without
int probe_gate(const float* A, const float* W, const float* bias, float* C,
               int M, int N, int K, int accumulate, int variant, int ctas,
               void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (variant == 0)
        return launch_gate_gemm(A, W, bias, C, M, N, K, st, accumulate);
    if (variant == 1)
        return tc_gate_gemm<true>(A, W, bias, C, M, N, K, accumulate, ctas,
                                  st);
    return tc_gate_gemm<false>(A, W, bias, C, M, N, K, accumulate, ctas, st);
}

int probe_atb(const float* A, const float* B, float* C, int K, int N1,
              int N2, int shift, int nsplit, int kslice, int variant,
              int ctas, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (variant == 0)
        return launch_atb_gemm(A, B, C, K, N1, N2, shift, nsplit, st);
    if (variant == 1)
        return tc_atb_gemm<true>(A, B, C, K, N1, N2, shift, nsplit, kslice,
                                 ctas, st);
    return tc_atb_gemm<false>(A, B, C, K, N1, N2, shift, nsplit, kslice,
                              ctas, st);
}

}  // extern "C"
