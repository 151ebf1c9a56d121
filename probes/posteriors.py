#!/usr/bin/env python3
"""Probe of the two posterior kernels on one card: the CRF backward (row
6, `crf_bwd`) and the logZ posteriors (row 3, `logz_posteriors`).  Run
from the root of a checkout, on a machine with nvcc and a card:

    python3 probes/posteriors.py [--v1-only] [--crf-k 8,16] [--logz-k 16,32]

It builds probes/posteriors.cu twice into taiyaki_tpu_torch/_build/ (nvcc,
ptxas' register and spill report printed for every kernel) and prints:

1. The earlier kernels (copied into the probe): their time (CUDA events, mean
   of 3 calls after one), the time without the CRF's atomics and of the
   chain alone, and a step's cycles by phase (thread 0 of every block, or
   lane 0 of every row, averaged over rows and steps) at the CRF's
   training shape (T=800, B=256, L=512, S=40), the cat_mod width (S=46)
   and L=3712 (T=4000, B=64); logZ at the basecall shape (T=1000, B=128)
   and the training shape (T=800, B=256), nbase 4.
2. Unless --v1-only: the redesigned kernels of csrc/ at each K given
   (the CRF's steps a batch, logZ's segment length; 0 is the kernels' own
   rule), each against its plain twin (max |err|), run twice (bitwise
   equal or not), and timed.

Inputs are seeded: random normal lp with random flip-flop sequences of
L/2 .. L positions (cat_mod: a weighted mod column in every move, weights
0.5 .. 8), logZ scores 5 tanh(normal), as chip_smoke.py makes them.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from taiyaki_tpu_torch import flipflopfings  # noqa: E402
from taiyaki_tpu_torch.ops import crf, flipflop, logz  # noqa: E402

CRF_SHAPES = ((800, 256, 512, 40), (800, 256, 512, 46), (4000, 64, 3712, 40))
LOGZ_SHAPES = ((1000, 128), (800, 256))
CRF_PHASES = ("lp load", "position loop", "barrier 1 (max)",
              "scatter (exp, atomics)", "barrier 2 (sum)", "grad store")
# the redesigned backward's phases (csrc/crf.cu BwdClock), a step
BWD_PHASES = ("lp wait", "chain arithmetic", "chain barriers",
              "lattice wait", "pass A", "exponentials", "pass B", "grad rows")
LOGZ_PHASES = ("bwd shuffles", "terms + group max", "exp + group sum",
               "divides + stores", "chain (lse, group max)", "load wait")


def build(kind):
    out = os.path.join(ROOT, "taiyaki_tpu_torch", "_build",
                       "posteriors_{}.so".format(kind))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    flags = ["-DPROBE_LOGZ"] if kind == "logz" else []
    res = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"] + flags
        + ["-o", out, os.path.join(ROOT, "probes", "posteriors.cu")],
        capture_output=True, text=True)
    if res.returncode:
        print(res.stdout[-4000:], res.stderr[-8000:], flush=True)
        raise SystemExit("nvcc failed")
    print("{} built in {:.1f} s; ptxas:".format(kind, time.time() - t0))
    func = None
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            # the kernel's name and template arguments, as mangled
            m = re.search(r"(v1)?\d*((crf|logz)_\w*kernel)(I\w*?EE)",
                          line.split("'")[1])
            func = m and "{}{}{}".format(m.group(1) or "", m.group(2),
                                         m.group(4))
        elif func and ("spill" in line or "Used" in line):
            print("  {} {}".format(func, line.split(":", 1)[-1].strip()))
    sys.stdout.flush()
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    if kind == "crf":
        lib.probe_crf_bwd_v1.argtypes = [P] * 9 + [I] * 6 + [P, P]
        lib.probe_crf_bwd.argtypes = [P] * 9 + [I] * 5 + [P, P]
    else:
        lib.probe_logz_post_v1.argtypes = [P] * 3 + [I] * 4 + [P, P]
        lib.probe_logz_post.argtypes = [P] * 3 + [I] * 4 + [P]
    return lib


def ms(fn, reps=3):
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


def kernel_times(fn, reps=10):
    """Device time (us a call) of each kernel fn launches, from
    torch.profiler over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            name = e.key.split("(")[-2] if "::" not in e.key else \
                e.key.split("::")[1]
            out.append("{} {:.1f} us".format(name.split("<")[0], us / reps))
    return ", ".join(out)


def ptrs(*ts):
    return [t.data_ptr() for t in ts]


def crf_case(T, B, L, S, rng):
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    seqlens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = mf = None
    if S > 40:
        mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1))
                              .astype(np.int32))
        mf = torch.from_numpy(rng.uniform(0.5, 8.0, size=(B, L - 1))
                              .astype(np.float32))
    idx = flipflop._lattice_inputs(stay, move, torch.from_numpy(seqlens), S,
                                   mm, mf)
    return [lp.cuda()] + [t.cuda() for t in idx]


def phases_line(cyc, T, names):
    mean = cyc.double().mean(0) / T
    return ", ".join("{} {:.0f}".format(n, v) for n, v in zip(names, mean))


def probe_crf(lib, ks, v1_only, rng):
    st = torch.cuda.current_stream().cuda_stream
    for T, B, L, S in CRF_SHAPES:
        lp, sidx, midx, mmidx, mfact, valid, last = crf_case(T, B, L, S, rng)
        idx = (sidx, midx, mmidx, mfact)
        _, _, lat = crf.crf_fwd_plain(lp, *idx, valid)
        g0 = crf.crf_bwd_plain(lp, *idx, lat, valid, last)
        args = ptrs(lp, *idx, lat, valid, last)
        grad = torch.empty_like(lp)
        cyc = torch.zeros(B, len(CRF_PHASES), dtype=torch.int64,
                          device="cuda")
        head = "crf_bwd T={} B={} L={} S={}".format(T, B, L, S)

        def v1(mode, clock):
            return lib.probe_crf_bwd_v1(*args, grad.data_ptr(), T, B, S, L,
                                        mode, clock, cyc.data_ptr(), st)
        assert v1(0, 0) == 0
        torch.cuda.synchronize()
        err = (grad - g0).abs().max().item()
        times = [ms(lambda: v1(m, 0)) for m in (0, 1, 2)]
        assert v1(0, 1) == 0
        torch.cuda.synchronize()
        print("{} v1: max|err| {:.3g}; {:.3f} ms, without atomics {:.3f}, "
              "chain alone {:.3f} ({:.2f} us a step); cycles a step "
              "(thread 0): {}".format(
                  head, err, *times, 1e3 * times[0] / T,
                  phases_line(cyc, T, CRF_PHASES)), flush=True)
        if v1_only:
            continue
        tol = (3e-4 if T > 1000 else 1e-5) * max(1.0, mfact.max().item())
        for k in ks:
            g1 = torch.empty_like(lp)
            g2 = torch.empty_like(lp)
            rc = lib.probe_crf_bwd(*args, g1.data_ptr(), T, B, S, L, k, None,
                                   st)
            rc |= lib.probe_crf_bwd(*args, g2.data_ptr(), T, B, S, L, k,
                                    None, st)
            torch.cuda.synchronize()
            if rc:
                print("{} K={}: launch refused ({})".format(head, k, rc),
                      flush=True)
                continue
            err = (g1 - g0).abs().max().item()
            t = ms(lambda: lib.probe_crf_bwd(*args, g1.data_ptr(), T, B, S,
                                             L, k, None, st))
            bcyc = torch.zeros(B, len(BWD_PHASES), dtype=torch.int64,
                               device="cuda")
            lib.probe_crf_bwd(*args, g2.data_ptr(), T, B, S, L, k,
                              bcyc.data_ptr(), st)
            torch.cuda.synchronize()
            print("{} K={}: max|err| {:.3g} (tol {:.3g}), bitwise repeat {}, "
                  "{:.3f} ms ({:.2f} us a step); cycles a step (thread 0): "
                  "{}".format(head, k, err, tol, torch.equal(g1, g2), t,
                              1e3 * t / T, phases_line(bcyc, T, BWD_PHASES)),
                  flush=True)
        del lp, lat, g0, grad
        torch.cuda.empty_cache()


def probe_logz(lib, ks, v1_only, rng):
    st = torch.cuda.current_stream().cuda_stream
    for T, B in LOGZ_SHAPES:
        s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(T, B, 40))))
                             .astype(np.float32)).cuda()
        _, _, lat = logz.logz_fwd_plain(s, 4)
        p0 = logz.logz_posteriors_plain(s, lat, 4)
        post = torch.empty_like(s)
        cyc = torch.zeros(B, len(LOGZ_PHASES), dtype=torch.int64,
                          device="cuda")
        head = "logz_posteriors T={} B={}".format(T, B)

        def v1(mode, clock):
            return lib.probe_logz_post_v1(s.data_ptr(), lat.data_ptr(),
                                          post.data_ptr(), T, B, mode, clock,
                                          cyc.data_ptr(), st)
        assert v1(0, 0) == 0
        torch.cuda.synchronize()
        err = (post - p0).abs().max().item()
        times = [ms(lambda: v1(m, 0), 5) for m in (0, 1)]
        assert v1(0, 1) == 0
        torch.cuda.synchronize()
        print("{} v1: max|err| {:.3g}; {:.3f} ms, chain alone {:.3f} ({:.2f} "
              "us a step); cycles a step (lane 0): {}".format(
                  head, err, *times, 1e3 * times[0] / T,
                  phases_line(cyc, T, LOGZ_PHASES)), flush=True)
        if v1_only:
            continue
        for k in ks:
            p1 = torch.empty_like(s)
            rc = lib.probe_logz_post(s.data_ptr(), lat.data_ptr(),
                                     p1.data_ptr(), T, B, 4, k, st)
            torch.cuda.synchronize()
            if rc:
                print("{} K={}: launch refused ({})".format(head, k, rc),
                      flush=True)
                continue
            err = (p1 - p0).abs().max().item()
            t = ms(lambda: lib.probe_logz_post(s.data_ptr(), lat.data_ptr(),
                                               p1.data_ptr(), T, B, 4, k,
                                               st), 10)
            print("{} K={}: max|err| {:.3g} (tol 1e-5), {:.4f} ms; {}".format(
                head, k, err, t, kernel_times(lambda: lib.probe_logz_post(
                    s.data_ptr(), lat.data_ptr(), p1.data_ptr(), T, B, 4, k,
                    st))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--v1-only", action="store_true",
                    help="the earlier kernels alone")
    ap.add_argument("--crf-k", default="0,4,8,16,24,32",
                    help="the CRF's steps a batch to try (0: its rule)")
    ap.add_argument("--logz-k", default="0,8,16,24,32,48,64",
                    help="logZ's segment lengths to try (0: its rule)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(1)
    probe_logz(build("logz"), [int(k) for k in args.logz_k.split(",")],
               args.v1_only, rng)
    probe_crf(build("crf"), [int(k) for k in args.crf_k.split(",")],
              args.v1_only, rng)


if __name__ == "__main__":
    sys.exit(main())
