#!/usr/bin/env python3
"""Probe of the two forward kernels on one card: the CRF forward (row 5,
`crf_fwd`) and the logZ forward (row 2, `logz_fwd`).  Run from the root
of a checkout, on a machine with nvcc and a card:

    python3 probes/forward.py [--v1-only] [--only crf|logz]
        [--logz-k 0,8,16,32] [--crf-k 8,16]

It builds probes/forward.cu twice into taiyaki_tpu_torch/_build/ (nvcc,
in parallel; ptxas' register and spill report printed for every kernel)
and prints, for each shape:

1. The earlier kernels (copied into the probe): their time (CUDA events,
   mean of 5 calls after one), error against the plain twin, and a step's
   cycles by phase (thread 0 of every block, or lane 0 of every row,
   averaged over rows and steps).  CRF: the training shape (T=800, B=256,
   L=512, S=40), the cat_mod width (S=46), the training step's lattice
   (L=640), L=3712 (T=4000, B=64) and L=8192 (T=1000, B=16); logZ: the
   basecall shape (T=1000, B=128), the training shape (T=800, B=256) and
   T=4000, B=64, nbase 4.
2. Unless --v1-only, the redesigns of csrc/.  The CRF forward in every
   layout the probe instantiates whose width (threads x positions x CTAs)
   holds L without doubling it, accurate and fast exponentials, each
   against the twin (score and lattice) and timed; csrc/crf.cu's own band
   at each steps-a-batch K given, with its phase clock (lp wait, lattice
   stores, positions, barrier).  The logZ forward at each segment length
   given (0: its rule), against the twin, with and without the lattice
   (bitwise the same logZ or not), timed, with its kernels' split
   (torch.profiler).

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

CRF_SHAPES = ((800, 256, 512, 40), (800, 256, 512, 46), (800, 256, 640, 40),
              (4000, 64, 3712, 40), (1000, 16, 8192, 40))
LOGZ_SHAPES = ((1000, 128), (800, 256), (4000, 64))
# the layouts probes/forward.cu instantiates: (threads a row, positions a
# thread, CTAs a row, fast exponentials)
ACCURATE = ((32, 4, 1), (32, 8, 1), (32, 16, 1), (64, 4, 1), (64, 8, 1),
            (128, 2, 1), (128, 4, 1), (128, 8, 1), (256, 1, 1), (256, 2, 1),
            (256, 4, 1), (256, 8, 1), (512, 1, 1), (512, 2, 1), (512, 4, 1),
            (512, 8, 1), (512, 16, 1), (1024, 2, 1), (1024, 4, 1),
            (1024, 8, 1),
            (256, 8, 2), (512, 4, 2), (512, 8, 2), (1024, 2, 2), (1024, 4, 2))
FAST = ((32, 16, 1), (64, 8, 1), (128, 4, 1), (256, 2, 1), (512, 1, 1),
        (256, 4, 1), (512, 2, 1), (1024, 4, 1), (512, 4, 2), (1024, 2, 2),
        (1024, 8, 1), (512, 16, 1), (512, 8, 2), (1024, 4, 2))
LAYOUTS = tuple(a + (0,) for a in ACCURATE) + tuple(a + (1,) for a in FAST)
V1_CRF_PHASES = ("lp load", "position loop", "barrier + max")
FWD_PHASES = ("lp wait", "lattice stores", "positions", "barrier")
V1_LOGZ_PHASES = ("store + shuffles", "lse", "group max, sum, log")


def build(kind):
    out = os.path.join(ROOT, "taiyaki_tpu_torch", "_build",
                       "forward_{}.so".format(kind))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    flags = ["-DPROBE_LOGZ"] if kind == "logz" else []
    return out, subprocess.Popen(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"] + flags
        + ["-o", out, os.path.join(ROOT, "probes", "forward.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(kind, out, proc, t0):
    stdout, stderr = proc.communicate()
    if proc.returncode:
        print(stdout[-4000:], stderr[-8000:], flush=True)
        raise SystemExit("nvcc failed")
    print("{} built in {:.1f} s; ptxas:".format(kind, time.time() - t0))
    func = None
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
            m = re.search(r"((crf|logz)_\w*kernel)(I\w*?EE)", func)
            func = "{}{}{}".format("v1 " if "v1" in func else "",
                                   m.group(1), m.group(3)) if m else func
        elif func and ("spill" in line or "Used" in line):
            print("  {} {}".format(func, line.split(":", 1)[-1].strip()))
    sys.stdout.flush()
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    if kind == "crf":
        lib.probe_crf_fwd_v1.argtypes = [P] * 9 + [I] * 5 + [P, P]
        lib.probe_crf_fwd.argtypes = [P] * 9 + [I] * 9 + [P, P]
        lib.tt_crf_fwd_layout.argtypes = [I]
    else:
        lib.probe_logz_fwd_v1.argtypes = [P] * 4 + [I] * 3 + [P, P]
        lib.probe_logz_fwd_scratch.argtypes = [I] * 4
        lib.probe_logz_fwd.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.tt_logz_fwd_segment.argtypes = [I] * 3
    return lib


def ms(fn, reps=5):
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
            m = re.search(r"\w*kernel\w*", e.key)
            out.append("{} {:.1f} us".format(m.group(0) if m else e.key,
                                             us / reps))
    return ", ".join(out)


def ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


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
    return [lp.cuda()] + [t.cuda() for t in idx[:5]]


def phases_line(cyc, T, names):
    mean = cyc.double().mean(0) / max(T, 1)
    return ", ".join("{} {:.0f}".format(n, v) for n, v in zip(names, mean))


def crf_errors(out, ref):
    """(score err, its tol, lattice err on live states, impossible states
    kept at or below NEG / 2)."""
    (f1, s1, l1), (f0, s0, l0) = out, ref
    live = l0 > crf.NEG / 2
    s_err = (s1 - s0).abs().max().item()
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    l_err = max((l1[live] - l0[live]).abs().max().item(),
                (f1 - f0)[f0 > crf.NEG / 2].abs().max().item())
    dead = bool((l1[~live] <= crf.NEG / 2).all())
    return s_err, s_tol, l_err, dead


def probe_crf(lib, ks, v1_only, rng):
    st = torch.cuda.current_stream().cuda_stream
    for T, B, L, S in CRF_SHAPES:
        lp, sidx, midx, mmidx, mfact, valid = crf_case(T, B, L, S, rng)
        args = ptrs(lp, sidx, midx, mmidx, mfact, valid)
        ref = crf.crf_fwd_plain(lp, sidx, midx, mmidx, mfact, valid)
        outs = (torch.empty(B, L, device="cuda"),
                torch.empty(B, device="cuda"),
                torch.empty(T, B, L, device="cuda"))
        optr = ptrs(*outs)
        head = "crf_fwd T={} B={} L={} S={}".format(T, B, L, S)

        def v1(clock, cyc=None):
            return lib.probe_crf_fwd_v1(*args, *optr, T, B, S, L, clock,
                                        None if cyc is None
                                        else cyc.data_ptr(), st)
        assert v1(0) == 0
        torch.cuda.synchronize()
        s_err, s_tol, l_err, dead = crf_errors(outs, ref)
        t_v1 = ms(lambda: v1(0))
        cyc = torch.zeros(B, len(V1_CRF_PHASES), dtype=torch.int64,
                          device="cuda")
        assert v1(1, cyc) == 0
        torch.cuda.synchronize()
        print("{} v1: score err {:.3g} (tol {:.3g}), lattice {:.3g}, "
              "impossible kept {}; {:.3f} ms ({:.2f} us a step); cycles a "
              "step (thread 0): {}".format(
                  head, s_err, s_tol, l_err, dead, t_v1, 1e3 * t_v1 / T,
                  phases_line(cyc, T, V1_CRF_PHASES)), flush=True)
        if v1_only:
            continue

        def new(nt, p, cl, fast, k, cyc=None):
            return lib.probe_crf_fwd(*args, *optr, T, B, S, L, nt, p, cl,
                                     fast, k, None if cyc is None
                                     else cyc.data_ptr(), st)
        for nt, p, cl, fast in LAYOUTS:
            width = nt * p * cl
            if width < L or width > max(2 * L, 128):
                continue
            rc = new(nt, p, cl, fast, 0)
            torch.cuda.synchronize()
            what = "{} layout {}x{}x{}{}".format(
                head, nt, p, cl, " fast" if fast else "")
            if rc:
                print("{}: refused ({})".format(what, rc), flush=True)
                continue
            s_err, s_tol, l_err, dead = crf_errors(outs, ref)
            lat = outs[2].clone()
            new(nt, p, cl, fast, 0)
            torch.cuda.synchronize()
            same = torch.equal(lat, outs[2])
            t = ms(lambda: new(nt, p, cl, fast, 0))
            print("{}: score err {:.3g} (tol {:.3g}), lattice {:.3g} (tol "
                  "1e-4), impossible kept {}, bitwise repeat {}; {:.3f} ms "
                  "({:.2f} us a step; v1 {:.3f})".format(
                      what, s_err, s_tol, l_err, dead, same, t, 1e3 * t / T,
                      t_v1), flush=True)
        packed = lib.tt_crf_fwd_layout(L)
        band = "{}x{}x{}".format(packed >> 16, (packed >> 8) & 0xff,
                                 packed & 0xff)
        for k in ks:
            rc = new(0, 0, 0, 0, k)
            torch.cuda.synchronize()
            if rc:
                print("{} band {} K={}: refused ({})".format(head, band, k,
                                                             rc), flush=True)
                continue
            s_err, s_tol, l_err, dead = crf_errors(outs, ref)
            t = ms(lambda: new(0, 0, 0, 0, k))
            fcyc = torch.zeros(B, len(FWD_PHASES), dtype=torch.int64,
                               device="cuda")
            new(0, 0, 0, 0, k, fcyc)
            torch.cuda.synchronize()
            print("{} band {} K={}: score err {:.3g}, lattice {:.3g}; {:.3f} "
                  "ms ({:.2f} us a step); cycles a step (first thread of a "
                  "row): {}".format(head, band, k, s_err, l_err, t,
                                    1e3 * t / T,
                                    phases_line(fcyc, T, FWD_PHASES)),
                  flush=True)
        del lp, ref, outs
        torch.cuda.empty_cache()


def probe_logz(lib, ks, v1_only, rng):
    st = torch.cuda.current_stream().cuda_stream
    for T, B in LOGZ_SHAPES:
        s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(T, B, 40))))
                             .astype(np.float32)).cuda()
        f0, z0, l0 = logz.logz_fwd_plain(s, 4)
        fwd = torch.empty(B, 8, device="cuda")
        z = torch.empty(B, device="cuda")
        lat = torch.empty(T, B, 8, device="cuda")
        cyc = torch.zeros(B, len(V1_LOGZ_PHASES), dtype=torch.int64,
                          device="cuda")
        head = "logz_fwd T={} B={}".format(T, B)
        z_tol = 1e-3 + 1e-5 * z0.abs().max().item()

        def diff(a, b):
            """max |a - b|, an -inf in both counting as equal"""
            same = (a == b)
            return (a - b).abs().masked_fill(same, 0).max().item()

        def errs():
            return diff(z, z0), max(diff(lat, l0), diff(fwd, f0))

        def v1(clock):
            return lib.probe_logz_fwd_v1(*ptrs(s, fwd, z, lat), T, B, clock,
                                         cyc.data_ptr(), st)
        assert v1(0) == 0
        torch.cuda.synchronize()
        z_err, l_err = errs()
        t_v1 = ms(lambda: v1(0), 10)
        assert v1(1) == 0
        torch.cuda.synchronize()
        print("{} v1: logZ err {:.3g} (tol {:.3g}), lattice {:.3g}; {:.4f} "
              "ms ({:.3f} us a step); cycles a step (lane 0): {}".format(
                  head, z_err, z_tol, l_err, t_v1, 1e3 * t_v1 / T,
                  phases_line(cyc, T, V1_LOGZ_PHASES)), flush=True)
        if v1_only:
            continue
        for k in ks:
            kk = k if k > 0 else lib.tt_logz_fwd_segment(T, B, 4)
            n = lib.probe_logz_fwd_scratch(T, B, 4, kk)
            scratch = torch.empty(max(n, 1), device="cuda")

            def run(lattice=lat):
                return lib.probe_logz_fwd(*ptrs(s, fwd, z, lattice, scratch),
                                          T, B, 4, kk, st)
            rc = run()
            torch.cuda.synchronize()
            if rc:
                print("{} K={}: refused ({})".format(head, kk, rc),
                      flush=True)
                continue
            z_err, l_err = errs()
            z1 = z.clone()
            run(None)
            torch.cuda.synchronize()
            same = torch.equal(z1, z)
            t = ms(run, 10)
            print("{} K={}{}: logZ err {:.3g} (tol {:.3g}), lattice and "
                  "fwd_final {:.3g} (tol 1e-4), logZ without the lattice "
                  "bitwise equal {}; {:.4f} ms (v1 {:.4f}); {}".format(
                      head, kk, " (its rule)" if k <= 0 else "", z_err,
                      z_tol, l_err, same, t, t_v1, kernel_times(run)),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--v1-only", action="store_true",
                    help="the earlier kernels alone")
    ap.add_argument("--logz-k", default="0,8,12,16,24,32,48,64",
                    help="logZ's segment lengths to try (0: its rule)")
    ap.add_argument("--crf-k", default="4,8,16,32",
                    help="the CRF band's steps a batch to try")
    ap.add_argument("--only", choices=("crf", "logz"),
                    help="probe one of the two kernels")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    kinds = (args.only,) if args.only else ("logz", "crf")
    builds = {kind: build(kind) for kind in kinds}
    libs = {kind: load(kind, *builds[kind], t0) for kind in builds}
    rng = np.random.default_rng(1)
    if "logz" in libs:
        probe_logz(libs["logz"], [int(k) for k in args.logz_k.split(",")],
                   args.v1_only, rng)
    if "crf" in libs:
        probe_crf(libs["crf"], [int(k) for k in args.crf_k.split(",")],
                  args.v1_only, rng)


if __name__ == "__main__":
    sys.exit(main())
