// The two GEMMs of gemm.cuh as entry points of their own (ops/gemm.py
// `gate_gemm`, `atb_gemm`), each on the plan of ops/gemm.py `gemm_plan`:
// the tests and chip_smoke.py hold each instance against its plain twin
// and time it at the layers' shapes.  The layers launch the same kernels
// from lstm.cu and gru.cu.  The products replace what the TPU kernels of
// taiyaki_tpu/ops/pallas_rnn.py compute in their bodies: the input
// product of the forwards (`_fused_gates`, pallas_rnn.py:805-817), d_x,
// d_iW and d_sW of the backwards (:299-305, :367-373, :608-614,
// :1168-1174, :1299-1306) and the gate streams the recomputing backwards
// rebuild (:590, :1267).  A bf16 operand (the gate product's A, the atb
// product's B) or a bf16 gate output (d_x) takes the instances of the
// LSTM layers' bf16 streams.

#include <cuda_runtime.h>

#include "gemm.cuh"

extern "C" {

const char* tt_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C [M, N] = A [M, K] . W [N, K]^T (+ bias [N], may be null) (+ the C it
// finds, with accumulate), on `plan` (GEMM_PLAN_INTS ints).  A is bf16
// with a_bf16, C with c_bf16 (not both, and not with accumulate); the rest
// f32; contiguous, on one device.  A plan the shape cannot take returns
// cudaErrorInvalidValue before any launch; else cudaGetLastError().
int tt_gate_gemm(const void* A, const float* W, const float* bias, void* C,
                 int M, int N, int K, int accumulate, int a_bf16, int c_bf16,
                 const int* plan, void* stream)
{
    const GemmPlan p = gemm_plan_at(plan, 0);
    const GemmIn a{A, a_bf16 != 0};
    if ((a_bf16 && c_bf16) || (c_bf16 && accumulate))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = gate_plan_check(p, a, W, K);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(gemm_gate(p, a, W, bias, GemmOut{C, c_bf16 != 0},
                                      M, N, K,
                                      static_cast<cudaStream_t>(stream),
                                      accumulate != 0));
}

// C [nsplit, N1, N2]: partial z = sum over the rows k of slice z of
// A [K, N1]^T B [K, N2] shifted by `shift` rows (rows of B outside [0, K)
// read as zero), on `plan` (its nsplit and kslice); B bf16 with b_bf16.
// Returns as tt_gate_gemm.
int tt_atb_gemm(const float* A, const void* B, float* C, int K, int N1,
                int N2, int shift, int b_bf16, const int* plan, void* stream)
{
    const GemmPlan p = gemm_plan_at(plan, 0);
    const GemmIn b{B, b_bf16 != 0};
    cudaError_t err = atb_plan_check(p, A, b, K, N1, N2);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (K == 0)
        return static_cast<int>(cudaMemsetAsync(
            C, 0, sizeof(float) * p.nsplit * N1 * N2,
            static_cast<cudaStream_t>(stream)));
    return static_cast<int>(gemm_atb(p, A, b, C, K, N1, N2, shift,
                                     static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
