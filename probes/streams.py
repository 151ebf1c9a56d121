#!/usr/bin/env python3
"""Probe of the CRF on score streams on one card: the forward (row 9,
`crf_fwd_streams`) and the backward (row 10, `crf_bwd_posteriors`, and
the route's d lp, `crf_grad_streams`).  Run from the root of a checkout,
on a machine with nvcc and a card:

    python3 probes/streams.py [--v1-only] [--ks 2,4,8]

It builds probes/streams.cu into taiyaki_tpu_torch/_build/ (ptxas'
register and spill report printed for every kernel) and prints, for each
shape (T=800, B=256, L=512, S=46, the cat_mod training shape; L=3712,
T=4000, B=64; L=9000, T=10000, B=8; L=20000, T=20100, B=1):

1. The earlier kernels (copied into the probe): their time (CUDA events,
   mean of a few calls after one) and a step's cycles by phase (thread 0
   of every block, averaged over rows and steps); the route's
   `scatter_add_` of their posteriors into d lp, timed.
2. Unless --v1-only, the redesigns of csrc/crf.cu in the same call: the
   forward and backward chains in every layout the probe instantiates
   whose width holds L, at each ring depth K given (0: the kernel's
   rule), against the first design's lattice and posteriors; the
   posterior pass alone ("post" and "grad" epilogues); the bands' whole
   entries (`crf_fwd_streams`, `crf_bwd_posteriors`, `crf_grad_streams`)
   against the first design, with their rerun bitwise or not.

Inputs are seeded as chip_smoke.py makes them: random normal lp of 46
columns, random flip-flop sequences (L/2 .. L positions, or L-300 .. L
past 8192), a weighted mod column in every move (weights 0.5 .. 8), the
streams selected by the route's own gather.
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
from taiyaki_tpu_torch.ops import crf, flipflop  # noqa: E402

S = 46
SHAPES = ((800, 256, 512), (4000, 64, 3712), (10000, 8, 9000),
          (20100, 1, 20000))
V1_FWD_PHASES = ("positions", "barrier + max", "stream wait")
V1_BWD_PHASES = ("positions + terms", "barrier (maxima)", "exps + sum",
                 "barrier (sum)", "posterior stores", "stream wait")
# the redesign: the chain's phases (csrc/crf.cu FWD_PHASES), the pass's
CHAIN_PHASES = ("stream wait", "lattice stores", "positions", "barrier")
POST_PHASES = ("terms + max", "exps + sum", "epilogue")
# the chain layouts probes/streams.cu instantiates beside the bands: (most
# threads a row, positions a thread, CTAs a row)
LAYOUTS = ((512, 2, 1), (1024, 1, 1), (1024, 2, 1), (1024, 4, 1),
           (1024, 2, 2), (1024, 4, 2), (1024, 4, 4), (1024, 2, 8),
           (1024, 4, 8), (1024, 8, 4))


def build():
    out = os.path.join(ROOT, "taiyaki_tpu_torch", "_build", "streams.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    proc = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         out, os.path.join(ROOT, "probes", "streams.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
        raise SystemExit("nvcc failed")
    print("built in {:.1f} s; ptxas:".format(time.time() - t0))
    func = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
            m = re.search(r"(crf_\w*kernel)(I\w*?EE)", func)
            func = "{}{}{}".format("v1 " if "v1" in func else "",
                                   m.group(1), m.group(2)) if m else func
        elif func and ("spill" in line or "Used" in line):
            if "streams" in func or "chain" in func or "post" in func \
                    or "lists" in func:
                print("  {} {}".format(func, line.split(":", 1)[-1].strip()))
    sys.stdout.flush()
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_fwd_v1.argtypes = [P] * 7 + [I] * 4 + [P, P]
    lib.probe_bwd_v1.argtypes = [P] * 8 + [I] * 4 + [P, P]
    lib.probe_chain.argtypes = [P] * 8 + [I] * 8 + [P, P]
    lib.probe_list_ints.argtypes = [I] * 3
    lib.probe_list_ints.restype = ctypes.c_longlong
    lib.probe_post_gex.argtypes = [I] * 3
    lib.probe_post_gex.restype = ctypes.c_longlong
    lib.probe_lists.argtypes = [P] * 7 + [I] * 3 + [P]
    lib.probe_post.argtypes = [P] * 11 + [I] * 5 + [P, P]
    lib.probe_row6.argtypes = [P] * 9 + [I] * 4 + [P]
    lib.tt_crf_streams_layout.argtypes = [I]
    lib.tt_crf_streams_scratch.argtypes = [I] * 5
    lib.tt_crf_streams_scratch.restype = ctypes.c_longlong
    lib.tt_crf_bwd_posteriors.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.tt_crf_grad_streams.argtypes = [P] * 11 + [I] * 4 + [P]
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


def ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def case(T, B, L, rng):
    """Streams stay, move [T, B, L], valid, last and the lattice inputs
    (sidx, midx, mmidx, mfact) of the route, on the card."""
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    lo = L // 2 if L <= 8192 else L - 300
    seqlens = rng.integers(lo, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1))
                          .astype(np.int32))
    mf = torch.from_numpy(rng.uniform(0.5, 8.0, size=(B, L - 1))
                          .astype(np.float32))
    idx = [t.cuda() for t in flipflop._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), S, mm, mf)]
    sidx, midx, mmidx, mfact, valid, last = idx
    lp = lp.cuda()
    st, mv = flipflop._select_streams(lp, sidx, midx, mmidx, mfact)
    return lp, st, mv, valid, last, (sidx, midx, mmidx, mfact)


def phases_line(cyc, T, names):
    mean = cyc.double().mean(0) / max(T, 1)
    return ", ".join("{} {:.0f}".format(n, v) for n, v in zip(names, mean))


def diff(a, b):
    """max |a - b|, equal values (NEG in both) counting as no difference"""
    return (a - b).abs().masked_fill(a == b, 0).max().item()


def probe(lib, ks, v1_only, rng):
    cs = torch.cuda.current_stream().cuda_stream
    for T, B, L in SHAPES:
        lp, st, mv, valid, last, idx = case(T, B, L, rng)
        reps = 5 if L <= 4096 else 2
        head = "T={} B={} L={} S={}".format(T, B, L, S)
        gstate = torch.empty(B, 2, L, device="cuda")
        fwd = torch.empty(B, L, device="cuda")
        score = torch.empty(B, device="cuda")
        lat = torch.empty(T, B, L, device="cuda")
        ps = torch.empty(T, B, L, device="cuda")
        pm = torch.empty(T, B, L, device="cuda")

        def f_v1(clock=0, cyc=None):
            return lib.probe_fwd_v1(*ptrs(st, mv, valid, fwd, score, lat,
                                          gstate), T, B, L, clock,
                                    None if cyc is None else cyc.data_ptr(),
                                    cs)

        def b_v1(clock=0, cyc=None):
            return lib.probe_bwd_v1(*ptrs(st, mv, lat, valid, last, ps, pm,
                                          gstate), T, B, L, clock,
                                    None if cyc is None else cyc.data_ptr(),
                                    cs)
        assert f_v1() == 0 and b_v1() == 0
        torch.cuda.synchronize()
        tf = ms(f_v1, reps)
        tb = ms(b_v1, reps)
        fcyc = torch.zeros(B, 3, dtype=torch.int64, device="cuda")
        bcyc = torch.zeros(B, 6, dtype=torch.int64, device="cuda")
        assert f_v1(1, fcyc) == 0 and b_v1(1, bcyc) == 0
        torch.cuda.synchronize()
        ref = (fwd.clone(), score.clone(), lat.clone(), ps.clone(),
               pm.clone())
        ts = ms(lambda: flipflop._scatter_posteriors(
            lp.shape, ps, pm.clone(), *idx), reps)
        tc = ms(lambda: pm.clone(), reps)
        print("{} v1 forward: {:.3f} ms ({:.2f} us a step); cycles a step "
              "(thread 0): {}".format(head, tf, 1e3 * tf / T, phases_line(
                  fcyc, T, V1_FWD_PHASES)), flush=True)
        print("{} v1 backward: {:.3f} ms ({:.2f} us a step); cycles a step "
              "(thread 0): {}".format(head, tb, 1e3 * tb / T, phases_line(
                  bcyc, T, V1_BWD_PHASES)), flush=True)
        print("{} scatter_add_ into d lp: {:.3f} ms (its post_move copy "
              "{:.3f} ms)".format(head, ts - tc, tc), flush=True)
        if not v1_only:
            probe_new(lib, ks, T, B, L, lp, st, mv, valid, last, idx, ref,
                      reps, head, tb + ts - tc)
        del lp, st, mv, lat, ps, pm, ref, gstate
        torch.cuda.empty_cache()


def layouts(L):
    """The probe's chain layouts at L, each as launched (the fewest warps
    of its most that hold L): clusters only past 2048 positions, 8
    positions a thread only past 8192; duplicates dropped."""
    out = []
    for most, p, cl in LAYOUTS:
        if most * p * cl < L or (cl > 1 and L <= 2048) or (p > 4
                                                           and L <= 8192):
            continue
        lay = (32 * max(2, -(-L // (32 * p * cl))), p, cl)
        if lay not in [o[1] for o in out]:
            out.append(((most, p, cl), lay))
    return out


def fwd_errors(outs, ref):
    """(score err, its tol, lattice and fwd_final err on live states,
    impossible states kept at or below NEG / 2)."""
    (f1, s1, l1), (f0, s0, l0) = outs, ref
    live = l0 > crf.NEG / 2
    s_err = (s1 - s0).abs().max().item()
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    l_err = max((l1[live] - l0[live]).abs().max().item(),
                (f1 - f0)[f0 > crf.NEG / 2].abs().max().item())
    return s_err, s_tol, l_err, bool((l1[~live] <= crf.NEG / 2).all())


def probe_new(lib, ks, T, B, L, lp, st, mv, valid, last, idx, ref, reps,
              head, t_route_v1):
    cs = torch.cuda.current_stream().cuda_stream
    fwd0, score0, lat0, ps0, pm0 = ref
    sidx, midx, mmidx, mfact = idx
    band = lib.tt_crf_streams_layout(L)
    band = (band >> 16, (band >> 8) & 0xff, band & 0xff) if band else None
    gstate = (torch.empty(B, 2, L, device="cuda") if band is None
              else None)
    fwd = torch.empty(B, L, device="cuda")
    score = torch.empty(B, device="cuda")
    lat = torch.empty(T, B, L, device="cuda")
    blat = torch.empty(T, B, L, device="cuda")

    def chain(bwd, most, p, cl, k, cyc=None):
        return lib.probe_chain(*ptrs(st, mv, valid, last, fwd, score,
                                     blat if bwd else lat, gstate),
                               T, B, L, bwd, most, p, cl, k,
                               None if cyc is None else cyc.data_ptr(), cs)
    # the bands first: the reference backward lattice
    assert chain(1, 0, 0, 0, 0) == 0
    torch.cuda.synchronize()
    blat0 = blat.clone()
    print("{} band {}".format(head, "x".join(map(str, band)) if band
                              else "device-memory instance"), flush=True)
    for bwd in (0, 1):
        what = "backward chain" if bwd else "forward"
        runs = [((0, 0, 0), band or "gmem", k) for k in ks]
        runs += [(most, lay, 0) for most, lay in layouts(L)
                 if lay != band]
        for most, lay, k in runs:
            rc = chain(bwd, *most, k)
            torch.cuda.synchronize()
            name = "{} {} {}{}".format(
                head, what, "x".join(map(str, lay)) if lay != "gmem"
                else lay, " K={}".format(k) if k else "")
            if rc:
                print("{}: refused ({})".format(name, rc), flush=True)
                continue
            if bwd:
                err = "backward lattice bitwise the band's {}".format(
                    torch.equal(blat, blat0))
            else:
                s_err, s_tol, l_err, dead = fwd_errors(
                    (fwd, score, lat), (fwd0, score0, lat0))
                err = ("score err {:.3g} (tol {:.3g}), lattice {:.3g}, "
                       "impossible kept {}".format(s_err, s_tol, l_err,
                                                   dead))
            t = ms(lambda: chain(bwd, *most, k), reps)
            print("{}: {}; {:.3f} ms ({:.2f} us a step)".format(
                name, err, t, 1e3 * t / T), flush=True)
        if band is not None:
            cyc = torch.zeros(B, len(CHAIN_PHASES), dtype=torch.int64,
                              device="cuda")
            chain(bwd, 0, 0, 0, 0, cyc)
            torch.cuda.synchronize()
            print("{} {} band: cycles a step (first thread of a row): {}"
                  .format(head, what, phases_line(cyc, T, CHAIN_PHASES)),
                  flush=True)
    del lat, fwd
    # the posterior pass alone, on the band's backward lattice
    ngex = lib.probe_post_gex(L, S, 1)
    gex = torch.empty(max(ngex, 1), device="cuda") if ngex else None
    lists = torch.empty(lib.probe_list_ints(B, L, S), dtype=torch.int32,
                        device="cuda")
    ps, pm = torch.empty_like(lat0), torch.empty_like(lat0)
    grad = torch.empty(T, B, S, device="cuda")
    want = crf.scatter_posteriors((T, B, S), ps0, pm0.clone(), *idx)
    weight = max(1.0, mfact.max().item())

    def post(g, cyc=None):
        out = (grad, None) if g else (ps, pm)
        return lib.probe_post(*ptrs(st, mv, lat0, blat0, valid, last, mfact,
                                    lists, *out, gex), T, B, L, S, g,
                              None if cyc is None else cyc.data_ptr(), cs)

    def lists_run():
        return lib.probe_lists(*ptrs(sidx, midx, mmidx, mfact, valid, last,
                                     lists), B, L, S, cs)
    assert lists_run() == 0 and post(0) == 0 and post(1) == 0
    torch.cuda.synchronize()
    p_err = max(diff(ps, ps0), diff(pm, pm0))
    g_err = diff(grad, want)
    t_lists = ms(lists_run, reps)
    t_post = ms(lambda: post(0), reps)
    t_grad = ms(lambda: post(1), reps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pcyc = torch.zeros(sms * 32, len(POST_PHASES), dtype=torch.int64,
                       device="cuda")
    post(1, pcyc)
    torch.cuda.synchronize()
    pcyc = pcyc[pcyc.sum(1) > 0]
    per_cta = (T * B) / max(len(pcyc), 1)
    print("{} posterior pass{}: post max |err| {:.3g} against the first "
          "design, {:.3f} ms; grad max |err| {:.3g} (mod weights to {:.2f}) "
          "against its posteriors scattered, {:.3f} ms; column lists {:.3f} "
          "ms; grad cycles an item (thread 0 of {} CTAs): {}".format(
              head, " (exponentials in device memory)" if ngex else "",
              p_err, t_post, g_err, weight, t_grad, t_lists, len(pcyc),
              phases_line(pcyc, per_cta, POST_PHASES)), flush=True)
    del ps, pm, blat, gex, lists
    torch.cuda.empty_cache()
    # the whole entries, as the port's wrappers call them
    fn = lib.tt_crf_streams_scratch
    scratch = torch.empty(max(fn(T, B, L, S, 1), 1), device="cuda")
    ps, pm = torch.empty_like(lat0), torch.empty_like(lat0)

    def entry_post():
        return lib.tt_crf_bwd_posteriors(*ptrs(st, mv, lat0, valid, last,
                                               ps, pm, scratch), T, B, L, cs)

    def entry_grad(out):
        return lib.tt_crf_grad_streams(*ptrs(st, mv, lat0, valid, last,
                                             sidx, midx, mmidx, mfact, out,
                                             scratch), T, B, L, S, cs)
    assert entry_post() == 0
    torch.cuda.synchronize()
    p_err = max(diff(ps, ps0), diff(pm, pm0))
    ps1, pm1 = ps.clone(), pm.clone()
    assert entry_post() == 0
    torch.cuda.synchronize()
    p_same = torch.equal(ps, ps1) and torch.equal(pm, pm1)
    g1 = torch.empty(T, B, S, device="cuda")
    assert entry_grad(grad) == 0 and entry_grad(g1) == 0
    torch.cuda.synchronize()
    g_err = diff(grad, want)
    g_same = torch.equal(grad, g1)
    t_ep = ms(entry_post, reps)
    t_eg = ms(lambda: entry_grad(grad), reps)
    print("{} crf_bwd_posteriors (chain + pass): max |err| {:.3g}, rerun "
          "bitwise {}, {:.3f} ms; crf_grad_streams (chain + lists + pass): "
          "max |err| {:.3g}, rerun bitwise {}, {:.3f} ms; the first design's "
          "backward and scatter {:.3f} ms".format(
              head, p_err, p_same, t_ep, g_err, g_same, t_eg, t_route_v1),
          flush=True)
    if T * B * L <= 800 * 256 * 512:
        # row 6, the in-block design (posteriors off the chain in the
        # chain's own block), on lp at this shape
        g6 = torch.empty(T, B, S, device="cuda")

        def row6():
            return lib.probe_row6(*ptrs(lp, sidx, midx, mmidx, mfact, lat0,
                                        valid, last, g6), T, B, S, L, cs)
        assert row6() == 0
        torch.cuda.synchronize()
        print("{} row 6's in-block design (crf_bwd on lp): max |diff| {:.3g} "
              "from crf_grad_streams, {:.3f} ms".format(
                  head, diff(g6, grad), ms(row6, reps)), flush=True)
    del scratch, ps, pm, grad, g1, want, blat0
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--v1-only", action="store_true",
                    help="the earlier kernels alone")
    ap.add_argument("--ks", default="0,2,4,8",
                    help="the chains' ring depths to try (0: the rule)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    probe(lib, [int(k) for k in args.ks.split(",")], args.v1_only,
          np.random.default_rng(1))


if __name__ == "__main__":
    sys.exit(main())
