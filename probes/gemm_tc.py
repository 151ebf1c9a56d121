#!/usr/bin/env python3
"""Probe of the two GEMMs' instances (csrc/gemm.cuh) on one card: the simt
kernels, the tc instance with PROMOTE and without (probes/gemm_tc.cu),
each held against an f64 product of the same inputs (largest error over
the largest |output|) and timed with CUDA events beside torch.matmul with
TF32 off; small ragged shapes first (tiles, k tails, the atb shift at
both signs and slice edges), then the layers' shapes.  Run from the root
of a checkout, on a machine with nvcc and a card:

    python3 probes/gemm_tc.py [--quick]

It builds its library into taiyaki_tpu_torch/_build/ (nvcc, with
ptxas' register and spill report) and prints one line a case.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("simt", "tc", "tc_nopromote")
# (M, N, K) of the gate product; (K rows, N1, N2) of the atb product
GATE_SHAPES = [(1000, 300, 100), (129, 8, 4), (300, 96, 96),
               (204800, 1024, 256), (204800, 256, 1024),
               (512000, 768, 256), (204600, 1536, 384), (128000, 1024, 256),
               (256000, 384, 96), (256000, 96, 384)]
ATB_SHAPES = [(1000, 40, 20), (4100, 132, 260), (204800, 1024, 256),
              (512000, 768, 256), (204600, 1536, 384), (256000, 384, 96)]


def build():
    out = os.path.join(ROOT, "taiyaki_tpu_torch", "_build", "gemm_probe.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-o", out,
                    os.path.join(ROOT, "probes", "gemm_tc.cu")], check=True)
    print("built in {:.1f} s".format(time.time() - t0), flush=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_gate.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.probe_atb.argtypes = [P] * 3 + [I] * 8 + [P]
    return lib


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def gate_case(lib, M, N, K, sms, reps, accumulate):
    g = torch.Generator(device="cuda").manual_seed(M + N + K)
    A = torch.randn(M, K, device="cuda", generator=g)
    W = torch.randn(N, K, device="cuda", generator=g) / K ** 0.5
    bias = torch.randn(N, device="cuda", generator=g)
    C0 = torch.randn(M, N, device="cuda", generator=g)
    ref = A.double() @ W.double().t() + bias.double()
    if accumulate:
        ref += C0.double()
    st = torch.cuda.current_stream().cuda_stream
    ctas = min(sms, -(-M // 128) * -(-N // 128))
    line = {}
    for v, name in enumerate(VARIANTS):
        C = C0.clone()
        rc = lib.probe_gate(A.data_ptr(), W.data_ptr(), bias.data_ptr(),
                            C.data_ptr(), M, N, K, int(accumulate), v, ctas,
                            st)
        torch.cuda.synchronize()
        assert rc == 0, (name, rc)
        line[name] = err(C, ref)
        if reps:
            line[name + "_ms"] = ms(lambda: lib.probe_gate(
                A.data_ptr(), W.data_ptr(), bias.data_ptr(), C.data_ptr(), M,
                N, K, 0, v, ctas, st), reps)
    line["matmul"] = err(torch.addmm(bias, A, W.t()) + (C0 if accumulate
                                                        else 0), ref)
    if reps:
        line["matmul_ms"] = ms(lambda: torch.matmul(A, W.t()), reps)
    print("gate M={} N={} K={} acc={}: {}".format(
        M, N, K, accumulate, {k: float("{:.4g}".format(v))
                              for k, v in line.items()}), flush=True)


def atb_case(lib, K, N1, N2, shift, nsplit, sms, reps):
    g = torch.Generator(device="cuda").manual_seed(K + N1 + N2)
    A = torch.randn(K, N1, device="cuda", generator=g)
    B = torch.randn(K, N2, device="cuda", generator=g)
    Bs = torch.zeros_like(B, dtype=torch.float64)
    lo, hi = max(0, -shift), min(K, K - shift)
    Bs[lo:hi] = B[lo + shift:hi + shift].double()
    st = torch.cuda.current_stream().cuda_stream
    line = {}
    for v, name in enumerate(VARIANTS):
        kslice = -(-K // nsplit)
        n = nsplit
        if v:
            kslice = -(-kslice // 32) * 32
            n = -(-K // kslice)
        C = torch.full((n, N1, N2), float("nan"), device="cuda")
        ctas = min(sms, n * -(-N1 // 128) * -(-N2 // 128))
        rc = lib.probe_atb(A.data_ptr(), B.data_ptr(), C.data_ptr(), K, N1,
                           N2, shift, n, kslice, v, ctas, st)
        torch.cuda.synchronize()
        assert rc == 0, (name, rc)
        ref = torch.stack([A[z * kslice:(z + 1) * kslice].double().t()
                           @ Bs[z * kslice:(z + 1) * kslice]
                           for z in range(n)])
        line[name] = err(C, ref)
        line[name + "_sum"] = err(C.sum(0), ref.sum(0))
        if reps:
            line[name + "_ms"] = ms(lambda: lib.probe_atb(
                A.data_ptr(), B.data_ptr(), C.data_ptr(), K, N1, N2, shift,
                n, kslice, v, ctas, st), reps)
    if reps:
        line["matmul_ms"] = ms(lambda: torch.matmul(A.t(), B), reps)
    print("atb K={} N1={} N2={} shift={} nsplit={}: {}".format(
        K, N1, N2, shift, nsplit, {k: float("{:.4g}".format(v))
                                   for k, v in line.items()}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the small shapes and the first large one only")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gates = GATE_SHAPES[:4] if args.quick else GATE_SHAPES
    for M, N, K in gates:
        big = M * N * K > 1e9
        gate_case(lib, M, N, K, sms, 5 if big else 0, False)
        if not big:
            gate_case(lib, M, N, K, sms, 0, True)
    atbs = ATB_SHAPES[:3] if args.quick else ATB_SHAPES
    for K, N1, N2 in atbs:
        big = K * N1 * N2 > 1e9
        for shift, nsplit in ([(-8, 8)] if big else
                              [(0, 1), (-7, 3), (7, 3), (-40, 5)]):
            nsplit = max(1, sms // (-(-N1 // 128) * -(-N2 // 128))) \
                if big else nsplit
            atb_case(lib, K, N1, N2, shift, nsplit, sms, 5 if big else 0)


if __name__ == "__main__":
    sys.exit(main())
