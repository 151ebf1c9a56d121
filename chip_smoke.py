#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (taiyaki_tpu_torch) on one NVIDIA
card; run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

1. Card: name and power limit; builds the CUDA kernels from csrc/.
2. Kernels: each against its plain PyTorch twin on the card, with its time
   (CUDA events), the twin's time, one PyTorch call computing the same
   function where there is one, and its bound.  Basecall kernels at the
   basecall path's shapes (T=1000 blocks, B=128 chunks, H=256, S=40; the
   GRU forward also at H=96, the shipped remap model's width); LSTM and
   CRF training kernels at the mLstm training shape (T=800 blocks, B=256
   chunks, H=D=256, L=512 lattice positions, S=40); the CRF again at
   L=3712 (T=4000, above the mGru default chunk range's bound of 3637);
   the GRU forward and recomputing backward at the mGru training shape
   (T=2000, B=256, H=D=256), both directions.  Beside each default
   backward, on the same inputs, the backwards of the JAX trainer's other
   residual policies: the LSTM's from stored pre (kernel 11) and
   rebuilding pre (kernel 12), the GRU's from stored gate streams (kernel
   13), with the forward modes that feed them.
3. mLstm_flipflop 256/5/19, as in the earlier slices:
   a. training path: `taiyaki_tpu_torch.cli.train_flipflop` on the
      repo's mapped reads (RESULTS/training_ingredients/
      mapped_remap_samref.hdf5), chunk 4000, 256 chunks per batch, 8
      iterations: every loss finite, checkpoints written, every kernel of
      the path launched;
   b. card against CPU: one training step (loss and every gradient) on
      the same batch and seeded weights at full width, 8 chunks;
   c. basecall path: the trained checkpoint of (a) calls synthetic fast5
      reads (8 x 100k samples and one read shorter than a chunk) through
      `taiyaki_tpu_torch.cli.basecall` with its defaults, fasta and
      fastq.  Two reads are called again on the CPU: the calls must be
      equal, or, where a Viterbi tie flips a base, the card's path must
      score the CPU's best score within 1e-4 under the CPU's scores;
   d. profiles: stage wall times and device time by kernel of one
      basecall batch and of one training step (torch.profiler).
4. mGru_flipflop 256/2/19 (this slice), the same phases: (a) training,
   chunk 4000 (T=2000 blocks), 256 chunks, 8 iterations; (b) card
   against CPU, 8 chunks; (c) basecalling synthetic reads with a seeded
   checkpoint at size 256 (a briefly trained one calls few bases), and
   the three real reads of the mapped reads, written as fast5, with the
   shipped remap checkpoint (taiyaki_tpu/models/mGru_flipflop_remapping_
   model_r9_DNA.checkpoint): every read gets a record, the card's calls
   equal the CPU's (or the tie rule of 3c), and each call's semi-global
   identity against the read's reference is at least 0.80; (d) profiles.
5. Residual policies: the training path again under each switch of the
   JAX trainer (TAIYAKI_TPU_ACTS_BWD=0 and TAIYAKI_TPU_RECOMPUTE=1 for
   mLstm, TAIYAKI_TPU_NO_RECOMPUTE=1 for mGru; 4 iterations each): its
   backward kernel launched, the default backward not; the card-vs-CPU
   step under each switch, whose card gradients must also equal the
   default policy's on the card; and for all five policy/model pairs a
   full training step's time and peak device memory, and one layer's
   forward and backward time.
6. A `kernels` JSON line, the card line, and the result line
   {"ok": true, "device": {...}}.

Every kernel counter is set to 0 just before each path and read just
after.  Exits non-zero, printing no result line, if there is no card or
any phase fails.  Imports nothing of JAX.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM (dense): f32 outside the tensor cores and
# device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
T, B, H, NBASE = 1000, 128, 256, 4
# production training shape (misc/rnn_roofline.py, misc/crf_fusion_probe.py)
TT, TB, TL, S = 800, 256, 512, 40
# samples per training chunk, and the mGru training shape (bench.py's mGru
# cell: chunk 4000 at stride 2)
CHUNK = 4000
GT = 2000
# a lattice above the mGru default chunk range's bound, ceil(8000 / 2.2)
# = 3637 positions, padded to a multiple of 128
LT, LB, LL = 4000, 64, 3712
ROOT = os.path.dirname(os.path.abspath(__file__))
READS_HDF5 = os.path.join(ROOT, "RESULTS", "training_ingredients",
                          "mapped_remap_samref.hdf5")
REMAP_MODEL = os.path.join(ROOT, "taiyaki_tpu", "models",
                           "mGru_flipflop_remapping_model_r9_DNA.checkpoint")
# the two model files of the port's paths: (name, file, stride)
MLSTM = ("mLstm_flipflop", os.path.join(
    ROOT, "taiyaki_tpu_torch", "models", "mLstm_flipflop.py"), 5)
MGRU = ("mGru_flipflop", os.path.join(
    ROOT, "taiyaki_tpu_torch", "models", "mGru_flipflop.py"), 2)
# the residual policies of each cell (the JAX trainer's switches), the
# default first: (name, switches)
LSTM_POLICIES = (("acts", {}), ("pre", {"TAIYAKI_TPU_ACTS_BWD": "0"}),
                 ("recompute", {"TAIYAKI_TPU_RECOMPUTE": "1"}))
GRU_POLICIES = (("recompute", {}), ("stored",
                                    {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device time of fn() over `reps` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a, b):
    """max |a - b|, counting equal infinities as no difference."""
    d = (a - b).abs()
    return d.masked_fill(a == b, 0.0).max().item()


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- phase 2 -----------------------------------------------------------------

def check_lstm(torch, dev, rng):
    from taiyaki_tpu_torch.ops import lstm
    D = H
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev)
    iW = torch.from_numpy((rng.normal(size=(4 * H, D)) / np.sqrt(D))
                          .astype(np.float32)).to(dev)
    b = torch.from_numpy((0.5 * rng.normal(size=4 * H)).astype(np.float32)
                         ).to(dev)
    sW = torch.from_numpy((rng.normal(size=(4 * H, H)) / np.sqrt(H))
                          .astype(np.float32)).to(dev)
    err, ms, plain_ms = 0.0, {}, {}
    for reverse in (False, True):
        got = lstm.lstm_fwd(x, iW, b, sW, reverse=reverse)
        want = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse)
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              "lstm_fwd: bad output")
        err = max(err, max_abs_diff(got, want))
        ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd(
            x, iW, b, sW, reverse=reverse), reps=5)
        plain_ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
            x, iW, b, sW, reverse=reverse), reps=2)
    tol = 1e-4
    check(err <= tol, "lstm_fwd: max |err| {} > {}".format(err, tol))
    ref = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
        lib_h = ref(x)[0]
        lib_err = (lib_h - lstm.lstm_fwd(x, iW, b, sW)).abs().max().item()
        library_ms = cuda_ms(torch, lambda: ref(x), reps=5)
    nbytes = 4 * (T * B * D + 4 * H * D + 4 * H + 4 * H * H + T * B * H)
    flops = 2 * T * B * 4 * H * (D + H)
    bound, by = bound_ms(nbytes, flops)
    say("lstm_fwd   T={} B={} D=H={}: max|err| {:.3g} (tol {}), kernel "
        "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
        "torch.nn.LSTM {:.3f} ms (|diff| {:.3g}), bound {:.3f} ms ({}); "
        "serial floor: {} dependent steps".format(
            T, B, H, err, tol, ms[False], ms[True], plain_ms[False],
            plain_ms[True], library_ms, lib_err, bound, by, T))
    return dict(name="lstm_fwd", route="cuda",
                source="taiyaki_tpu_torch/csrc/lstm.cu",
                replaces="taiyaki_tpu/ops/pallas_rnn.py:880",
                max_abs_err=err, ms=ms[False],
                plain_ms=plain_ms[False], bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def check_logz(torch, dev, rng):
    from taiyaki_tpu_torch.ops import logz
    S = 2 * NBASE * (NBASE + 1)
    nff = 2 * NBASE
    s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(T, B, S))))
                         .astype(np.float32)).to(dev)
    f1, z1, l1 = logz.logz_fwd(s)
    p1 = logz.logz_posteriors(s, l1)
    f0, z0, l0 = logz.logz_fwd_plain(s, NBASE)
    p0 = logz.logz_posteriors_plain(s, l0, NBASE)
    torch.cuda.synchronize()
    z_err = max_abs_diff(z1, z0)
    z_tol = 1e-3 + 1e-5 * z0.abs().max().item()
    l_err = max(max_abs_diff(l1, l0), max_abs_diff(f1, f0))
    p_err = max_abs_diff(p1, p0)
    check(z_err <= z_tol, "logz_fwd: logZ max |err| {} > {}".format(
        z_err, z_tol))
    check(l_err <= 1e-4, "logz_fwd: lattice max |err| {} > 1e-4".format(
        l_err))
    check(p_err <= 1e-5, "logz_posteriors: max |err| {} > 1e-5".format(
        p_err))
    check(bool(torch.isfinite(p1).all()), "logz_posteriors: non-finite")
    f_ms = cuda_ms(torch, lambda: logz.logz_fwd(s), reps=10)
    f_plain = cuda_ms(torch, lambda: logz.logz_fwd_plain(s, NBASE), reps=2)
    p_ms = cuda_ms(torch, lambda: logz.logz_posteriors(s, l1), reps=10)
    p_plain = cuda_ms(torch, lambda: logz.logz_posteriors_plain(s, l1, NBASE),
                      reps=2)
    # ops per row and step: forward S adds, S exp, S max/sum, 2nff log/add;
    # posteriors about twice that
    f_bound, f_by = bound_ms(4 * (T * B * S + T * B * nff + B * nff + B),
                             T * B * (4 * S + 4 * nff))
    p_bound, p_by = bound_ms(4 * (2 * T * B * S + T * B * nff),
                             T * B * (8 * S + 4 * nff))
    say("logz_fwd   T={} B={} S={}: logZ max|err| {:.3g} (tol {:.3g}), "
        "lattice {:.3g} (tol 1e-4), kernel {:.3f} ms, plain {:.3f} ms, "
        "bound {:.4f} ms ({})".format(T, B, S, z_err, z_tol, l_err, f_ms,
                                      f_plain, f_bound, f_by))
    say("logz_posteriors: max|err| {:.3g} (tol 1e-5), kernel {:.3f} ms, "
        "plain {:.3f} ms, bound {:.4f} ms ({})".format(
            p_err, p_ms, p_plain, p_bound, p_by))
    return [dict(name="logz_fwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/logz.cu",
                 replaces="taiyaki_tpu/ops/pallas_logz.py:142",
                 max_abs_err=max(z_err, l_err), ms=f_ms, plain_ms=f_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=None),
            dict(name="logz_posteriors", route="cuda",
                 source="taiyaki_tpu_torch/csrc/logz.cu",
                 replaces="taiyaki_tpu/ops/pallas_logz.py:249",
                 max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                 bound_ms=p_bound, bound_by=p_by, library_ms=None)]


def rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def _tensor(torch, dev, a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def _bwd_err(torch, got, want, what):
    """Largest relative error of a backward's outputs against its twin's
    (weight-gradient partials summed), after checking they are finite."""
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "{}: non-finite output".format(what))
    return max([rel_err(got[0], want[0])]
               + [rel_err(g.sum(0), w.sum(0))
                  for g, w in zip(got[1:], want[1:])])


def check_lstm_train(torch, dev, rng):
    """The forward with emit="acts", "pre" and "c" and the three backwards
    (from acts, kernel 4; from pre, kernel 11; rebuilding pre, kernel 12)
    at the production training shape, both directions, against their
    twins, on the same inputs; cuDNN's LSTM (torch.nn.LSTM) forward with
    grad and its backward as the library yardsticks."""
    from taiyaki_tpu_torch.ops import lstm
    D = H
    x = _tensor(torch, dev, rng.normal(size=(TT, TB, D)))
    iW = _tensor(torch, dev, rng.normal(size=(4 * H, D)) / np.sqrt(D))
    b = _tensor(torch, dev, 0.5 * rng.normal(size=4 * H))
    sW = _tensor(torch, dev, rng.normal(size=(4 * H, H)) / np.sqrt(H))
    dh = _tensor(torch, dev, rng.normal(size=(TT, TB, H)))
    bwds = {"lstm_bwd_acts": (lstm.lstm_bwd_acts, lstm.lstm_bwd_acts_plain),
            "lstm_bwd_fusedw": (lstm.lstm_bwd_fusedw,
                                lstm.lstm_bwd_fusedw_plain),
            "lstm_bwd_recompute": (lstm.lstm_bwd_recompute,
                                   lstm.lstm_bwd_recompute_plain)}
    emits = ("acts", "pre", "c")
    f_err = dict.fromkeys(emits, 0.0)
    b_err = dict.fromkeys(bwds, 0.0)
    f_ms, f_plain = {}, {}
    b_ms = {k: {} for k in bwds}
    b_plain = {k: {} for k in bwds}
    for reverse in (False, True):
        want = {e: lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                       emit=e) for e in ("acts", "pre")}
        want["c"] = want["pre"][:2]
        for e in emits:
            got = lstm.lstm_fwd(x, iW, b, sW, reverse=reverse, emit=e)
            torch.cuda.synchronize()
            f_err[e] = max([f_err[e]] + [max_abs_diff(g, w) for g, w in
                                         zip(got, want[e])])
            del got
        h, c, acts, tc = want["acts"]
        pre = want["pre"][2]
        c_prev = lstm.prev_state(c, reverse)
        args = {"lstm_bwd_acts": (dh, acts, tc, c_prev, h, x, sW, iW),
                "lstm_bwd_fusedw": (dh, pre, c, c_prev, h, x, sW, iW),
                "lstm_bwd_recompute": (dh, c, h, x, sW, iW, b)}
        for k, (kernel, plain) in bwds.items():
            gk = kernel(*args[k], reverse=reverse)
            gp = plain(*args[k], reverse=reverse)
            torch.cuda.synchronize()
            b_err[k] = max(b_err[k], _bwd_err(torch, gk, gp, k))
            del gk, gp
            b_ms[k][reverse] = cuda_ms(torch, lambda: kernel(
                *args[k], reverse=reverse), reps=3)
            b_plain[k][reverse] = cuda_ms(torch, lambda: plain(
                *args[k], reverse=reverse), reps=1)
        if not reverse:
            for e in emits:
                f_ms[e] = cuda_ms(torch, lambda: lstm.lstm_fwd(
                    x, iW, b, sW, emit=e), reps=3)
                f_plain[e] = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
                    x, iW, b, sW, emit=e), reps=1)
        del want, args, h, c, acts, tc, pre, c_prev
        torch.cuda.empty_cache()
    for e in emits:
        check(f_err[e] <= 1e-4, "lstm_fwd({}): max |err| {} > 1e-4".format(
            e, f_err[e]))
    for k in bwds:
        check(b_err[k] <= 1e-4, "{}: max relative err {} > 1e-4".format(
            k, b_err[k]))
    ref = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
    xr = x.clone().requires_grad_()
    lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
    out = ref(xr)[0]
    lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=3)
    del out, xr
    # bytes of one [T, B, H] f32 stream, and of the weights
    nbh = 4 * TT * TB * H
    nw = 4 * 4 * H * (D + H + 1)
    x_bytes = 4 * TT * TB * D
    f_flops = 2 * TT * TB * 4 * H * (D + H)
    # streams written beside h, in [T, B, H] units
    f_out = {"acts": 1 + 4 + 1, "pre": 1 + 4, "c": 1}
    f_bound = {e: bound_ms(x_bytes + nw + (1 + f_out[e]) * nbh, f_flops)
               for e in emits}
    # the chain and d_sW (4H x H each), d_x and d_iW (4H x D each); the
    # rebuilding backward adds x iW^T and h_prev sW^T
    b_flops = 2 * TT * TB * 4 * H * (2 * H + 2 * D)
    stored_bytes = 8 * nbh + 2 * x_bytes + 2 * nw
    b_bound = {
        "lstm_bwd_acts": bound_ms(stored_bytes, b_flops),
        "lstm_bwd_fusedw": bound_ms(stored_bytes, b_flops),
        "lstm_bwd_recompute": bound_ms(3 * nbh + 2 * x_bytes + 2 * nw,
                                       2 * TT * TB * 4 * H * (3 * H + 3 * D))}
    for e in emits:
        say("lstm_fwd({}) T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms, plain {:.3f} ms, torch.nn.LSTM forward with "
            "grad {:.3f} ms, bound {:.3f} ms ({})".format(
                e, TT, TB, H, f_err[e], f_ms[e], f_plain[e], lib_f,
                *f_bound[e]))
    for k in bwds:
        say("{} T={} B={} D=H={}: max relative err {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
            "{:.3f} ms, torch.nn.LSTM backward {:.3f} ms, bound {:.3f} ms "
            "({})".format(k, TT, TB, H, b_err[k], b_ms[k][False],
                          b_ms[k][True], b_plain[k][False],
                          b_plain[k][True], lib_b, *b_bound[k]))
    fwd_rows = {e: dict(ms=f_ms[e], plain_ms=f_plain[e],
                        bound_ms=f_bound[e][0], max_abs_err=f_err[e],
                        library_ms=lib_f) for e in emits}
    replaces = {"lstm_bwd_acts": 385, "lstm_bwd_fusedw": 456,
                "lstm_bwd_recompute": 625}
    return fwd_rows, [dict(
        name=k, route="cuda", source="taiyaki_tpu_torch/csrc/lstm.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[k]),
        max_abs_err=b_err[k], ms=b_ms[k][False], plain_ms=b_plain[k][False],
        bound_ms=b_bound[k][0], bound_by=b_bound[k][1], library_ms=lib_b)
        for k in bwds]


def check_crf(torch, dev, rng, tt=TT, tb=TB, tl=TL, g_tol=1e-5):
    """The CRF forward and backward at T=tt, B=tb, L=tl against their
    twins (no PyTorch call computes either).  The gradient is held to
    g_tol: 1e-5 at the training shape; over T=4000 steps the log-space
    forward and backward lattices and the score of kernel and twin each
    drift apart by up to their 1e-4 tolerance, a posterior p =
    exp(fwd + bwd - score) moves by at most 3e-4 p, and a gradient
    entry sums posteriors of total at most 1, so 3e-4 there."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import crf, flipflop
    lp = _tensor(torch, dev, rng.normal(size=(tt, tb, S)))
    seqlens = rng.integers(tl // 2, tl + 1, size=tb).astype(np.int32)
    seqs = np.zeros((tb, tl), np.int32)
    for i in range(tb):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, NBASE, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), NBASE)
    args = [a.to(dev) for a in flipflop._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), S)]
    sidx, midx, mmidx, mfact, valid, last = args
    idx = (sidx, midx, mmidx, mfact)
    f1, s1, lat1 = crf.crf_fwd(lp, *idx, valid)
    f0, s0, lat0 = crf.crf_fwd_plain(lp, *idx, valid)
    g1 = crf.crf_bwd(lp, *idx, lat1, valid, last)
    g2 = crf.crf_bwd(lp, *idx, lat1, valid, last)
    g0 = crf.crf_bwd_plain(lp, *idx, lat0, valid, last)
    torch.cuda.synchronize()
    live = lat0 > crf.NEG / 2
    check(bool((lat1[~live] <= crf.NEG / 2).all()),
          "crf_fwd: impossible states differ")
    l_err = (lat1[live] - lat0[live]).abs().max().item()
    s_err = (s1 - s0).abs().max().item()
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    g_err = max_abs_diff(g1, g0)
    g_rerun = max_abs_diff(g1, g2)
    del f0, s0, lat0, g0, g2
    check(s_err <= s_tol, "crf_fwd: score err {} > {}".format(s_err, s_tol))
    check(l_err <= 1e-4, "crf_fwd: lattice err {} > 1e-4".format(l_err))
    check(g_err <= g_tol, "crf_bwd: max |err| {} > {}".format(g_err, g_tol))
    check(g_rerun <= 1e-6, "crf_bwd: run-to-run {} > 1e-6".format(g_rerun))
    f_ms = cuda_ms(torch, lambda: crf.crf_fwd(lp, *idx, valid), reps=5)
    f_plain = cuda_ms(torch, lambda: crf.crf_fwd_plain(lp, *idx, valid),
                      reps=1)
    b_ms = cuda_ms(torch, lambda: crf.crf_bwd(lp, *idx, lat1, valid, last),
                   reps=5)
    b_plain = cuda_ms(torch, lambda: crf.crf_bwd_plain(
        lp, *idx, lat1, valid, last), reps=1)
    # positions this data needs: each row's valid ones; per position and
    # step ~10 f32 operations forward (logaddexp, max), ~20 backward
    npos = int(seqlens.sum())
    idx_bytes = 4 * 6 * tb * tl
    f_bound, f_by = bound_ms(4 * (tt * tb * S + tt * tb * tl + tb * tl + tb)
                             + idx_bytes, 10 * tt * npos)
    b_bound, b_by = bound_ms(4 * (2 * tt * tb * S + tt * tb * tl)
                             + idx_bytes, 20 * tt * npos)
    say("crf_fwd T={} B={} L={} S={}: score err {:.3g} (tol {:.3g}), "
        "lattice {:.3g} (tol 1e-4), kernel {:.3f} ms, plain {:.3f} ms, "
        "bound {:.4f} ms ({})".format(tt, tb, tl, S, s_err, s_tol, l_err,
                                      f_ms, f_plain, f_bound, f_by))
    say("crf_bwd T={} B={} L={}: d lp max |err| {:.3g} (tol {:.0e}), run to "
        "run {:.3g} (tol 1e-6), kernel {:.3f} ms, plain {:.3f} ms, bound "
        "{:.4f} ms ({})".format(tt, tb, tl, g_err, g_tol, g_rerun, b_ms,
                                b_plain, b_bound, b_by))
    return [dict(name="crf_fwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:423",
                 max_abs_err=max(s_err, l_err), ms=f_ms, plain_ms=f_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=None),
            dict(name="crf_bwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:565",
                 max_abs_err=g_err, ms=b_ms, plain_ms=b_plain,
                 bound_ms=b_bound, bound_by=b_by, library_ms=None)]


def _gru_inputs(torch, dev, rng, t, b, d, h):
    x = _tensor(torch, dev, rng.normal(size=(t, b, d)))
    iW = _tensor(torch, dev, rng.normal(size=(3 * h, d)) / np.sqrt(d))
    bias = _tensor(torch, dev, 0.5 * rng.normal(size=3 * h))
    sW = _tensor(torch, dev, rng.normal(size=(3 * h, h)) / np.sqrt(h))
    return x, iW, bias, sW


def _torch_gru(torch, dev, x, iW, b, sW):
    """cuDNN's GRU holding the same weights, its hidden bias zero: the
    same function (gate order r, z, n).  A yardstick only."""
    ref = torch.nn.GRU(x.shape[2], sW.shape[1]).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
    return ref


def _gru_fwd_bound(t, b, d, h):
    return bound_ms(4 * (t * b * d + 3 * h * (d + h + 1) + t * b * h),
                    2 * t * b * (d + h) * 3 * h)


def check_gru(torch, dev, rng):
    """The GRU forward (kernel 7) at the basecall shape (T=1000, B=128) at
    H=D=256 and at the shipped remap model's H=D=96, both directions,
    against its twin; cuDNN's GRU forward as the library yardstick."""
    from taiyaki_tpu_torch.ops import gru
    out = {}
    for h in (H, 96):
        x, iW, b, sW = _gru_inputs(torch, dev, rng, T, B, h, h)
        err, ms, plain = 0.0, {}, {}
        for reverse in (False, True):
            got = gru.gru_fwd(x, iW, b, sW, reverse=reverse)
            want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  "gru_fwd: bad output")
            err = max(err, max_abs_diff(got, want))
            ms[reverse] = cuda_ms(torch, lambda: gru.gru_fwd(
                x, iW, b, sW, reverse=reverse), reps=5)
            plain[reverse] = cuda_ms(torch, lambda: gru.gru_fwd_plain(
                x, iW, b, sW, reverse=reverse), reps=2)
        check(err <= 1e-4, "gru_fwd H={}: max |err| {} > 1e-4".format(h, err))
        ref = _torch_gru(torch, dev, x, iW, b, sW)
        with torch.no_grad():
            lib_err = (ref(x)[0] - gru.gru_fwd(x, iW, b, sW)).abs().max()
            lib_ms = cuda_ms(torch, lambda: ref(x), reps=5)
        bound, by = _gru_fwd_bound(T, B, h, h)
        say("gru_fwd    T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), kernel "
            "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
            "torch.nn.GRU {:.3f} ms (|diff| {:.3g}), bound {:.3f} ms ({}); "
            "serial floor: {} dependent steps".format(
                T, B, h, err, ms[False], ms[True], plain[False],
                plain[True], lib_ms, lib_err.item(), bound, by, T))
        out[h] = dict(name="gru_fwd", route="cuda",
                      source="taiyaki_tpu_torch/csrc/gru.cu",
                      replaces="taiyaki_tpu/ops/pallas_rnn.py:995",
                      max_abs_err=err, ms=ms[False], plain_ms=plain[False],
                      bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return out[H], out[96]


def check_gru_train(torch, dev, rng):
    """The GRU forward without and with its gate streams (kernel 7), the
    recomputing backward (kernel 8) and the backward from stored gate
    streams (kernel 13) at the mGru training shape (T=2000, B=256,
    H=D=256), both directions, against their twins on the same inputs;
    cuDNN's GRU forward with grad and its backward as the library
    yardsticks."""
    from taiyaki_tpu_torch.ops import gru, lstm
    x, iW, b, sW = _gru_inputs(torch, dev, rng, GT, TB, H, H)
    dh = _tensor(torch, dev, rng.normal(size=(GT, TB, H)))
    bwds = {"gru_bwd_recompute": (gru.gru_bwd_recompute,
                                  gru.gru_bwd_recompute_plain),
            "gru_bwd_fusedw": (gru.gru_bwd_fusedw, gru.gru_bwd_fusedw_plain)}
    f_err = {False: 0.0, True: 0.0}
    b_err = dict.fromkeys(bwds, 0.0)
    f_ms, f_plain = {}, {}
    b_ms = {k: {} for k in bwds}
    b_plain = {k: {} for k in bwds}
    for reverse in (False, True):
        want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                                 emit_residuals=True)
        for res in (False, True):
            got = gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                              emit_residuals=res)
            torch.cuda.synchronize()
            # h alone, or (h, gh, gx)
            outs = got if res else (got,)
            f_err[res] = max([f_err[res]] + [max_abs_diff(g, w)
                                             for g, w in zip(outs, want)])
            del got, outs
        h, gh, gx = want
        args = {"gru_bwd_recompute": (dh, h, x, sW, iW, b),
                "gru_bwd_fusedw": (dh, gx, gh, lstm.prev_state(h, reverse),
                                   x, sW, iW)}
        for k, (kernel, plain) in bwds.items():
            gk = kernel(*args[k], reverse=reverse)
            gp = plain(*args[k], reverse=reverse)
            torch.cuda.synchronize()
            b_err[k] = max(b_err[k], _bwd_err(torch, gk, gp, k))
            del gk, gp
            b_ms[k][reverse] = cuda_ms(torch, lambda: kernel(
                *args[k], reverse=reverse), reps=3)
            b_plain[k][reverse] = cuda_ms(torch, lambda: plain(
                *args[k], reverse=reverse), reps=1)
        for res in (False, True):
            f_ms[res, reverse] = cuda_ms(torch, lambda: gru.gru_fwd(
                x, iW, b, sW, reverse=reverse, emit_residuals=res), reps=3)
        if not reverse:
            for res in (False, True):
                f_plain[res] = cuda_ms(torch, lambda: gru.gru_fwd_plain(
                    x, iW, b, sW, emit_residuals=res), reps=1)
        del want, args, h, gh, gx
        torch.cuda.empty_cache()
    for res in (False, True):
        check(f_err[res] <= 1e-4, "gru_fwd (training shape, emit_residuals="
              "{}): max |err| {} > 1e-4".format(res, f_err[res]))
    for k in bwds:
        check(b_err[k] <= 1e-4, "{}: max relative err {} > 1e-4".format(
            k, b_err[k]))
    ref = _torch_gru(torch, dev, x, iW, b, sW)
    xr = x.clone().requires_grad_()
    lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
    out = ref(xr)[0]
    lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=3)
    del out, xr, ref
    f_bound = {False: _gru_fwd_bound(GT, TB, H, H)}
    # gh and gx written beside h: six more [T, B, H] streams
    f_bound[True] = bound_ms(
        4 * (GT * TB * H + 3 * H * (2 * H + 1) + 7 * GT * TB * H),
        2 * GT * TB * 2 * H * 3 * H)
    nw = 4 * (2 * 3 * H * 2 * H + 2 * 3 * H)
    one = 2 * GT * TB * 3 * H * H
    b_bound = {
        # gx and gh rebuilt, the dh chain, d_x, d_iW, d_sW: six products
        "gru_bwd_recompute": bound_ms(4 * 4 * GT * TB * H + nw, 6 * one),
        # dh, gx, gh, h_prev, x in, d_x out: four products
        "gru_bwd_fusedw": bound_ms(4 * 10 * GT * TB * H + nw, 4 * one)}
    for res in (False, True):
        say("gru_fwd(emit_residuals={}) T={} B={} D=H={}: max|err| {:.3g} "
            "(tol 1e-4), kernel {:.3f} ms fwd / {:.3f} ms reverse, plain "
            "{:.3f} ms, torch.nn.GRU forward with grad {:.3f} ms, bound "
            "{:.3f} ms ({})".format(res, GT, TB, H, f_err[res],
                                    f_ms[res, False], f_ms[res, True],
                                    f_plain[res], lib_f, *f_bound[res]))
    for k in bwds:
        say("{} T={} B={} D=H={}: max relative err {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
            "{:.3f} ms, torch.nn.GRU backward {:.3f} ms, bound {:.3f} ms "
            "({})".format(k, GT, TB, H, b_err[k], b_ms[k][False],
                          b_ms[k][True], b_plain[k][False],
                          b_plain[k][True], lib_b, *b_bound[k]))
    fwd_rows = {res: dict(ms=f_ms[res, False], plain_ms=f_plain[res],
                          bound_ms=f_bound[res][0], max_abs_err=f_err[res],
                          library_ms=lib_f) for res in (False, True)}
    replaces = {"gru_bwd_recompute": 1311, "gru_bwd_fusedw": 1184}
    return fwd_rows, [dict(
        name=k, route="cuda", source="taiyaki_tpu_torch/csrc/gru.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[k]),
        max_abs_err=b_err[k], ms=b_ms[k][False], plain_ms=b_plain[k][False],
        bound_ms=b_bound[k][0], bound_by=b_bound[k][1], library_ms=lib_b)
        for k in bwds]


# -- phases 3 and 4 ----------------------------------------------------------

@contextlib.contextmanager
def switches(env):
    """The residual-policy switches `env` set in os.environ, restored on
    exit."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_path(torch, work, seed, counters, model, policy=None,
               niter=8, idle=()):
    """The training CLI on the card with the model file of `model` (name,
    path, stride) at size 256, under the switch of `policy` (name,
    environment) if given, for `niter` iterations; the kernels `idle`
    (the default backward) must not launch.  Returns (launches, stats,
    outdir)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    name, model_py, stride = model
    tag = name if policy is None else "{} {}".format(name, policy[0])
    outdir = os.path.join(work, "train_" + tag.replace(" ", "_"))
    for fn in counters.values():
        fn.launches = 0
    with switches({} if policy is None else policy[1]):
        stats = train_flipflop.main([
            "--size", str(H), "--stride", str(stride), "--winlen", "19",
            "--chunk_len_min", str(CHUNK), "--chunk_len_max", str(CHUNK),
            "--min_sub_batch_size", str(TB), "--niteration", str(niter),
            "--warmup_batches", "2", "--save_every", str(niter // 2),
            "--sample_nreads_before_filtering", "1000",
            "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
            "--outdir", outdir, model_py, READS_HDF5])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check((n == 0) if k in idle else (n > 0),
              "{} training path launched kernel {} {} times".format(
                  tag, k, n))
    with open(os.path.join(outdir, "batch.log")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    check(len(losses) == niter and all(np.isfinite(losses)),
          "{} batch.log losses {}".format(tag, losses))
    for ckpt in ("model_checkpoint_00001", "model_checkpoint_00002",
                 "model_final"):
        check(os.path.exists(os.path.join(outdir, ckpt + ".checkpoint")),
              "{}: no checkpoint {}".format(tag, ckpt))
    say("training path ({} {}/{}/19, chunk {}, {} chunks, {} iterations): "
        "losses {}; {:.3f} s in the loop (validation and checkpoints "
        "included): {:.4f} steps/s, {:.2f} trained ksample/s; launches "
        "{}".format(tag, H, stride, CHUNK, TB, niter,
                    ", ".join("{:.5f}".format(v) for v in losses),
                    stats["seconds"], stats["iterations"] / stats["seconds"],
                    stats["samples"] / stats["seconds"] / 1e3, launches))
    return launches, stats, outdir


def step_batch(seed, nchunk, model):
    """A seeded batch of nchunk CHUNK-sample chunks from the repo's reads,
    and the factory kwargs of `model` at size 256."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    stride = model[2]
    with mapped_signal_files.MappedSignalReader(READS_HDF5) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = chunk_selection.sample_filter_parameters(
        reads, 200, CHUNK, 3.0, 10.0, 0.5, 5, 1.1)
    batch, _ = train.sample_batch(reads, CHUNK, nchunk,
                                  train.max_seqlen_for_chunk(CHUNK, stride),
                                  alphabet, fp, seqlen_granularity=128)
    return batch, dict(insize=1, size=H, winlen=19, stride=stride,
                       alphabet_info=alphabet)


def new_net(seed, kwargs, device, model):
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    net, _, _ = helpers.new_model(model[1], **kwargs)
    params = net.init(np.random.default_rng(seed))
    return load_jax_params(net, params).to(device)


def card_vs_cpu(torch, dev, seed, model, policies=()):
    """One training step's loss and gradients on the card and on the CPU
    twins, same batch and weights, full width, 8 chunks: by default, and
    under each of `policies` (name, switches), whose card gradients must
    also equal the default's on the card.  Tolerances: loss 1e-5 relative
    (f32 sums in another order through 800 or 2000 steps of 5 recurrent
    layers and the lattice); each gradient 1e-5 of its tensor's largest
    value."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    batch, kwargs = step_batch(seed, 8, model)
    names = None

    def step(device, env):
        nonlocal names
        with switches(env):
            net = new_net(seed, kwargs, device, model)
            t0 = time.perf_counter()
            loss, grads = train.make_grad_step(net)(
                train.batch_to_device(batch, device), 1.0)
            grads = [g.cpu() for g in grads]
        names = leaf_names(net)
        return float(loss), grads, time.perf_counter() - t0

    def compare(what, a, b):
        l_err = abs(a[0] - b[0]) / max(1.0, abs(b[0]))
        errs = [rel_err(x, y) for x, y in zip(a[1], b[1])]
        worst = names[int(np.argmax(errs))]
        check(l_err <= 1e-5, "{} ({}): loss {} vs {}".format(
            what, model[0], a[0], b[0]))
        check(max(errs) <= 1e-5, "{} ({}): gradient err {} ({})".format(
            what, model[0], max(errs), worst))
        return ("loss {} vs {} (relative err {:.3g}, tol 1e-5); {} "
                "gradients, largest relative err {:.3g} in {} (tol "
                "1e-5)".format(a[0], b[0], l_err, len(a[1]), max(errs),
                               worst))

    card, cpu = step(dev, {}), step(torch.device("cpu"), {})
    say("card vs CPU, one {} step (8 chunks x {} samples, size {}): {}; CPU "
        "twins {:.1f} s".format(model[0], CHUNK, H,
                                compare("card vs CPU", card, cpu), cpu[2]))
    for name, env in policies:
        pcard, pcpu = step(dev, env), step(torch.device("cpu"), env)
        say("{} {} step: card vs the default on the card: {} (loss {}); "
            "card vs CPU: {}; CPU twins {:.1f} s".format(
                model[0], name, compare(name + " vs default", pcard, card),
                "bitwise equal" if pcard[0] == card[0] else "not bitwise",
                compare(name + " card vs CPU", pcard, pcpu), pcpu[2]))


def layer_bwd_ms(torch, dev, model, policy, T):
    """Forward with grad and backward (ms, CUDA events) of one recurrent
    layer of `model` under `policy`, at the training step's shape (T
    blocks, 256 chunks, H=D=256); the backward runs on a retained graph
    and must give the same gradients every time."""
    from taiyaki_tpu_torch.ops import rnn
    cell = "lstm" if model is MLSTM else "gru"
    G = (4 if cell == "lstm" else 3) * H
    rng = np.random.default_rng(0)
    leaves = [_tensor(torch, dev, a).requires_grad_() for a in (
        rng.normal(size=(T, TB, H)), rng.normal(size=(G, H)) / np.sqrt(H),
        0.5 * rng.normal(size=G), rng.normal(size=(G, H)) / np.sqrt(H))]
    dh = _tensor(torch, dev, rng.normal(size=(T, TB, H)))
    layer = rnn.lstm_layer if cell == "lstm" else rnn.gru_layer
    with switches(policy[1]):
        f_ms = cuda_ms(torch, lambda: layer(*leaves), reps=2)
        h = layer(*leaves)
    first = torch.autograd.grad(h, leaves, dh, retain_graph=True)
    b_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        h, leaves, dh, retain_graph=True), reps=3)
    again = torch.autograd.grad(h, leaves, dh)
    check(all(bool(torch.equal(a, b)) for a, b in zip(first, again)),
          "{} {}: a retained graph gave other gradients".format(
              model[0], policy[0]))
    return f_ms, b_ms


def policy_steps(torch, dev, seed):
    """Each residual policy's full training step (256 chunks x CHUNK
    samples; mean synchronised wall time of 2 steps after a warm-up) and
    its peak device memory (torch.cuda.max_memory_allocated over one
    step), with one layer's forward and backward at the step's shape.
    Returns {(model, policy): numbers}."""
    from taiyaki_tpu_torch import train
    out = {}
    for model, policies in ((MLSTM, LSTM_POLICIES), (MGRU, GRU_POLICIES)):
        batch, kwargs = step_batch(seed, TB, model)
        for policy in policies:
            with switches(policy[1]):
                net = new_net(seed, kwargs, dev, model)
                params = train.leaf_params(net)
                opt, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
                threshs = np.full(len(params), np.inf, np.float32)
                b = train.batch_to_device(batch, dev)
                step = train.make_train_step(net, opt)
                step(b, 1.0, threshs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                for _ in range(2):
                    step(b, 1.0, threshs)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / 2
                peak = torch.cuda.max_memory_allocated(dev)
            del net, params, opt, b, step
            torch.cuda.empty_cache()
            f_ms, b_ms = layer_bwd_ms(torch, dev, model, policy,
                                      CHUNK // model[2])
            torch.cuda.empty_cache()
            out[model[0], policy[0]] = dict(
                step_ms=step_ms, peak_gb=peak / 1e9, layer_fwd_ms=f_ms,
                layer_bwd_ms=b_ms)
            say("residual policy {} {}: training step {:.3f} ms ({} chunks x "
                "{} samples), peak device memory {:.3f} GB; one layer at "
                "T={}, B={}, H=D={}: forward with grad {:.3f} ms, backward "
                "{:.3f} ms".format(model[0], policy[0], step_ms, TB, CHUNK,
                                   peak / 1e9, CHUNK // model[2], TB, H,
                                   f_ms, b_ms))
    return out


# -- phase 5 -----------------------------------------------------------------

def write_reads(path, names, lengths, rng):
    """A multi-read fast5 of synthetic step-like signals."""
    from taiyaki_tpu_torch.data.hdf5 import Writer
    with Writer(path) as f5:
        for rid, n in zip(names, lengths):
            levels = rng.normal(500.0, 60.0, size=n // 8 + 1)
            dacs = np.repeat(levels, 8)[:n] + rng.normal(0, 8.0, size=n)
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k, v in (("digitisation", 8192.0), ("offset", 4.0),
                         ("range", 1400.0), ("sampling_rate", 4000.0)):
                ch.attrs[k] = v
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = n
            raw.create_dataset("Signal", data=dacs.astype("i2"))


def read_fastx(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    step = 4 if lines and lines[0].startswith("@") else 2
    return {lines[i][1:]: lines[i + 1] for i in range(0, len(lines), step)}


def semiglobal_identity(call, ref):
    """1 - (edit distance of `ref` against the best-matching stretch of
    `call`) / len(ref): the call's unaligned ends are free, every base of
    the reference counts."""
    a = np.frombuffer(ref.encode(), np.uint8)
    b = np.frombuffer(call.encode(), np.uint8)
    j = np.arange(len(b) + 1)
    prev = np.zeros(len(b) + 1, np.int64)     # leading call bases free
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        # a call base against no reference base, along the row
        prev = np.minimum.accumulate(cur - j) + j
    return 1.0 - prev.min() / len(a)          # trailing call bases free


def path_score(trans, path, nbase):
    """Score of a flip-flop state path [T+1] under scores [T, S]."""
    nff = 2 * nbase
    src, dst = path[:-1], path[1:]
    col = np.where(dst < nbase, dst * nff + src, nff * nbase + src)
    start = 0.0 if path[0] < nbase else -1e30
    return start + float(trans[np.arange(len(src)), col].sum())


def tie_check(torch, model, reads_dir, read_ids, dev):
    """Per chunk of `read_ids`: the card's Viterbi path against the CPU's;
    a differing path must score the CPU's best within 1e-4 under the CPU's
    scores.  Returns (chunks, differing chunks, max |score gap|)."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.utils import helpers
    wanted = {}
    for fname, rid in fast5utils.iterate_fast5_reads(reads_dir):
        if rid in read_ids:
            wanted[rid] = fname
    net, params, *_ = helpers.load_model(model)
    stride = net.stride
    chunks = np.concatenate([basecall.prepare_read(
        rid, basecall.get_signal(wanted[rid], rid), T * stride,
        100 * stride, None, False)["chunks"] for rid in read_ids], axis=1)
    res = []
    for device in (dev, torch.device("cpu")):
        net = load_jax_params(net, params).to(device).eval()
        caller = basecall.Basecaller(net, 40, True, 1.0, chunks.shape[1],
                                     device, want_trans=True)
        with torch.inference_mode():
            out = caller.call_chunks(torch.from_numpy(chunks).to(device))
        res.append({k: v.cpu().numpy() for k, v in out.items()})
    gpu, cpu = res
    ndiff, gap = 0, 0.0
    for i in range(chunks.shape[1]):
        if np.array_equal(gpu["paths"][:, i], cpu["paths"][:, i]):
            continue
        ndiff += 1
        best = path_score(cpu["trans"][:, i], cpu["paths"][:, i], NBASE)
        got = path_score(cpu["trans"][:, i], gpu["paths"][:, i], NBASE)
        gap = max(gap, abs(best - got))
    check(gap <= 1e-4, "card Viterbi path scores {} below the CPU's best "
          "(tie tolerance 1e-4)".format(gap))
    trans_err = float(np.abs(np.exp(gpu["trans"]) - np.exp(cpu["trans"]))
                      .max())
    return chunks.shape[1], ndiff, gap, trans_err


def main_path(torch, dev, seed, work, model, counters, tag):
    """Basecall synthetic reads with the checkpoint `model` through the
    basecall CLI on the card; returns (launches, stats, reads dir)."""
    from taiyaki_tpu_torch.cli import basecall
    rng = np.random.default_rng(seed)
    reads = os.path.join(work, "reads_" + tag)
    os.makedirs(reads)
    names = ["read{:02d}".format(i) for i in range(9)]
    lengths = [100000] * 8 + [3000]          # the last is under one chunk
    write_reads(os.path.join(reads, "batch0.fast5"), names[:5], lengths[:5],
                rng)
    write_reads(os.path.join(reads, "batch1.fast5"), names[5:], lengths[5:],
                rng)
    nsample = sum(lengths)

    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, tag + ".fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, model])
    launches = {name: fn.launches for name, fn in counters.items()}
    torch.cuda.synchronize()
    calls = read_fastx(fa)
    # a read whose call is empty gets no record (as in bin/basecall.py);
    # a briefly trained model calls few bases, so count reads processed
    check(stats["nread"] == len(names) and set(calls) <= set(names)
          and len(calls) == stats["ncalled"] > 0,
          "fasta: {} of {} reads processed, records {}".format(
              stats["nread"], len(names), sorted(calls)))
    check(stats["nsample"] == nsample, "fasta: samples {}".format(
        stats["nsample"]))
    for name, n in launches.items():
        check(n > 0, "basecall path never launched kernel {}".format(name))
    say("basecall path ({}; fasta, defaults): {} reads, {} samples, {} bases "
        "in {:.3f} s: {:.3f} reads/s, {:.3f} ksample/s, {:.3f} kbase/s; "
        "launches {}".format(
            tag, stats["ncalled"], stats["nsample"], stats["nbase"],
            stats["seconds"], stats["ncalled"] / stats["seconds"],
            stats["nsample"] / stats["seconds"] / 1e3,
            stats["nbase"] / stats["seconds"] / 1e3, launches))

    fq = os.path.join(work, tag + ".fq")
    stats_q = basecall.main(["--output", fq, "--quiet", "--fastq", reads,
                             model])
    with open(fq) as fh:
        lines = fh.read().splitlines()
    check(len(lines) == 4 * len(calls), "fastq: {} lines".format(len(lines)))
    for i in range(0, len(lines), 4):
        check(lines[i + 1] == calls[lines[i][1:]]
              and len(lines[i + 3]) == len(lines[i + 1]),
              "fastq call of {} differs from fasta".format(lines[i][1:]))
    say("basecall path ({}; fastq): {} reads in {:.3f} s: {:.3f} ksample/s"
        .format(tag, stats_q["ncalled"], stats_q["seconds"],
        stats_q["nsample"] / stats_q["seconds"] / 1e3))

    cpu_fa = os.path.join(work, tag + "_cpu.fa")
    basecall.main(["--output", cpu_fa, "--quiet", "--device", "cpu",
                   "--limit", "2", reads, model])
    cpu_calls = read_fastx(cpu_fa)
    first = names[:2]
    nchunk, ndiff, gap, trans_err = tie_check(torch, model, reads, first,
                                              dev)
    same = [rid for rid in first if cpu_calls.get(rid) == calls.get(rid)]
    check(len(same) == 2 or ndiff > 0,
          "card and CPU calls differ with equal chunk paths")
    say("card vs CPU on {} reads: {} identical calls; {} of {} chunks with "
        "another Viterbi path (score gap {:.3g}, tol 1e-4); max |posterior "
        "diff| {:.3g}".format(len(first), len(same), ndiff, nchunk, gap,
                              trans_err))
    return launches, stats, reads


def write_real_reads(path):
    """The repo's mapped reads as one fast5 (hdf5.Writer, as a machine
    without h5py writes it); returns {read id: (reference sequence,
    samples)}."""
    from taiyaki_tpu_torch.data import mapped_signal_files
    from taiyaki_tpu_torch.data.hdf5 import Writer
    with mapped_signal_files.MappedSignalReader(READS_HDF5) as msr:
        alphabet = msr.get_alphabet_information().alphabet
        reads = list(msr.reads())
    refs = {}
    with Writer(path) as f5:
        for r in reads:
            grp = f5.create_group("read_" + r.read_id)
            ch = grp.create_group("channel_id")
            for k in ("digitisation", "offset", "range"):
                ch.attrs[k] = getattr(r, k)
            ch.attrs["sampling_rate"] = 4000.0
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = r.read_id
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = len(r.Dacs)
            raw.create_dataset("Signal", data=r.Dacs.astype("i2"))
            refs[r.read_id] = ("".join(alphabet[i] for i in r.Reference),
                               len(r.Dacs))
    return refs


def real_reads(torch, dev, work, counters):
    """The three real reads called with the shipped mGru remap checkpoint
    by the basecall CLI with its defaults on the card, then on the CPU
    twins: every read gets a record, the calls are equal (or the Viterbi
    tie rule of main_path holds), each identity is at least 0.80."""
    from taiyaki_tpu_torch.cli import basecall
    reads = os.path.join(work, "reads_real")
    os.makedirs(reads)
    refs = write_real_reads(os.path.join(reads, "real.fast5"))
    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, "real.fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, REMAP_MODEL])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = read_fastx(fa)
    check(sorted(calls) == sorted(refs), "real reads: records {} of {}"
          .format(sorted(calls), sorted(refs)))
    for k, n in launches.items():
        check(n > 0, "real-read basecall never launched kernel {}".format(k))
    cpu_fa = os.path.join(work, "real_cpu.fa")
    basecall.main(["--output", cpu_fa, "--quiet", "--device", "cpu", reads,
                   REMAP_MODEL])
    cpu_calls = read_fastx(cpu_fa)
    same = [rid for rid in refs if cpu_calls.get(rid) == calls[rid]]
    nchunk, ndiff, gap, trans_err = tie_check(torch, REMAP_MODEL, reads,
                                              sorted(refs), dev)
    check(len(same) == len(refs) or ndiff > 0,
          "real reads: card and CPU calls differ with equal chunk paths")
    ident = {rid: semiglobal_identity(calls[rid], ref)
             for rid, (ref, _) in refs.items()}
    say("real reads (shipped mGru remap checkpoint, size 96, stride 4; "
        "defaults): {} reads, {} samples, {} bases in {:.3f} s: {:.3f} "
        "ksample/s; launches {}; card vs CPU: {} of {} calls identical, {} "
        "of {} chunks with another Viterbi path (score gap {:.3g}, tol "
        "1e-4), max |posterior diff| {:.3g}; semi-global identity against "
        "the reference: {}".format(
            stats["ncalled"], stats["nsample"], stats["nbase"],
            stats["seconds"], stats["nsample"] / stats["seconds"] / 1e3,
            launches, len(same), len(refs), ndiff, nchunk, gap, trans_err,
            ", ".join("{} ({} samples, {} bases called, reference {}) "
                      "{:.4f}".format(rid, refs[rid][1], len(calls[rid]),
                                      len(refs[rid][0]), ident[rid])
                      for rid in sorted(refs))))
    worst = min(ident.values())
    check(worst >= 0.80, "real reads: identity {:.4f} < 0.80".format(worst))
    return launches, stats


def seeded_checkpoint(work, seed, model):
    """A checkpoint of `model` at size 256 with weights drawn from a
    seed."""
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.utils import helpers
    kwargs = dict(insize=1, size=H, winlen=19, stride=model[2])
    net, source, meta = helpers.new_model(
        model[1], model_metadata={"reverse": False, "standardize": True},
        **kwargs)
    load_jax_params(net, net.init(np.random.default_rng(seed)))
    outdir = os.path.join(work, "seeded_" + model[0])
    os.makedirs(outdir)
    return helpers.save_model(outdir, net, params_to_jax(net), source,
                              kwargs, meta)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_batch(torch, dev, model, reads_dir):
    """Where one 128-chunk batch of a basecall path spends its time: host
    wall time of each stage (synchronised), then torch.profiler's device
    time by kernel and the device's busy share over the batch."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.ops import decode
    from taiyaki_tpu_torch.utils import helpers
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
    stride = net.stride
    parts = []
    for fname, rid in fast5utils.iterate_fast5_reads(reads_dir):
        parts.append(basecall.prepare_read(
            rid, basecall.get_signal(fname, rid), T * stride, 100 * stride,
            None, False)["chunks"])
    chunks = np.concatenate(parts, axis=1)[:, :B]
    caller = basecall.Basecaller(net, 40, True, 1.0, B, dev,
                                 want_errprobs=True)
    x = torch.from_numpy(chunks).to(dev)

    def stages():
        out = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            out[name] = (now - t) * 1e3
            t = now
        y = x
        for i, layer in enumerate(net.sublayers):
            y = layer(y)
            lap("{}:{}".format(i, type(layer).__name__))
        trans = torch.log(decode.flipflop_make_trans(y) + 1e-8)
        lap("make_trans+log")
        _, _, paths = decode.flipflop_viterbi(trans)
        lap("viterbi")
        caller.errprobs(trans, paths)
        lap("errprobs")
        paths.cpu()
        lap("paths to host")
        return out

    with torch.inference_mode():
        stages()
        walls = stages()
        kern, wall = device_profile(torch, lambda: caller.call_chunks(x))
    total = sum(walls.values())
    say("basecall batch of {} chunks x {} samples, stage wall times (ms, "
        "synchronised): {} ; total {:.3f} ms".format(
            B, T * stride, ", ".join("{} {:.3f}".format(k, v)
                                     for k, v in walls.items()), total))
    say_profile("one call_chunks", kern, wall, total)


def device_profile(torch, fn):
    """torch.profiler over one fn(): [(kernel, device ms, launches)] and
    the profiled wall time (ms).  Fails if the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _device_us(e) > 0]
    check(len(kern) > 0, "torch.profiler recorded no device time")
    return kern, wall


def say_profile(what, kern, wall, total):
    # the profiled call's own wall time includes the profiler's start;
    # the busy share is taken against the unprofiled wall time
    busy = sum(k[1] for k in kern)
    say("profiler over {}: device busy {:.3f} ms, {:.1%} of the unprofiled "
        "{:.3f} ms (profiled wall {:.3f} ms); by kernel (ms, launches): "
        "{}".format(what, busy, busy / total, total, wall, "; ".join(
            "{} {:.3f} x{}".format(n[:60], t, c) for n, t, c in
            sorted(kern, key=lambda k: -k[1])[:10])))


def profile_train_step(torch, dev, seed, model):
    """Where one training step of `model` (256 chunks x CHUNK samples)
    spends its time: synchronised wall time of each stage (forward by
    layer, CRF loss, logZ, backward, clip + optimizer), then device time
    by kernel."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.ops import flipflop as ffops
    batch, kwargs = step_batch(seed, TB, model)
    net = new_net(seed, kwargs, dev, model)
    params = train.leaf_params(net)
    optimizer, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
    threshs = np.full(len(params), np.inf, np.float32)
    b = train.batch_to_device(batch, dev)

    def stages():
        out = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            out[name] = (now - t) * 1e3
            t = now
        y = b.signal
        for i, layer in enumerate(net.sublayers):
            y = layer(y)
            lap("{}:{}".format(i, type(layer).__name__))
        nblk = y.shape[0]
        loss = ffops.crf_flipflop_loss(y, b.seqs, b.seqlens, 1.0)
        lap("crf loss")
        logz = ffops.flipflop_logz(y) / nblk
        loss = (loss + logz).sum() / y.shape[1]
        lap("logZ")
        grads = torch.autograd.grad(loss, params)
        lap("backward")
        gmax = torch.stack([g.abs().max() for g in grads])
        optimizer.step([torch.clamp(g, -float(th), float(th))
                        for g, th in zip(grads, threshs)])
        gmax.cpu()
        lap("clip+optimizer")
        return out

    step = train.make_train_step(net, optimizer)
    stages()
    walls = stages()
    total = sum(walls.values())
    kern, wall = device_profile(torch, lambda: step(b, 1.0, threshs))
    say("{} training step of {} chunks x {} samples (T={} blocks, L={}), "
        "stage wall times (ms, synchronised): {} ; total {:.3f} ms".format(
            model[0], TB, CHUNK, CHUNK // model[2], batch.seqs.shape[1],
            ", ".join("{} {:.3f}".format(k, v) for k, v in walls.items()),
            total))
    say_profile("one {} training step".format(model[0]), kern, wall, total)


def run(seed):
    try:
        import torch
    except ImportError:
        raise SmokeFailure("PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA card: torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "taiyaki_tpu_torch", "csrc")):
        raise SmokeFailure("run chip_smoke.py from the root of a checkout "
                           "(taiyaki_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    from taiyaki_tpu_torch.ops import crf, cuda_lib, gru, logz, lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("card: {} (torch {}, CUDA {})".format(card, torch.__version__,
                                              torch.version.cuda))
    t0 = time.time()
    libs = cuda_lib.build_all()
    say("kernels built in {:.1f} s (nvcc, sm_90a): {}".format(
        time.time() - t0,
        ", ".join(os.path.basename(p) for p in libs.values())))

    rng = np.random.default_rng(seed)
    kernels = [check_lstm(torch, dev, rng)] + check_logz(torch, dev, rng)
    lstm_fwd_rows, lstm_bwd_rows = check_lstm_train(torch, dev, rng)
    kernels += lstm_bwd_rows + check_crf(torch, dev, rng)
    torch.cuda.empty_cache()
    long_crf = check_crf(torch, dev, rng, LT, LB, LL, g_tol=3e-4)
    torch.cuda.empty_cache()
    gru_row, gru96_row = check_gru(torch, dev, rng)
    gru_fwd_rows, gru_bwd_rows = check_gru_train(torch, dev, rng)
    kernels += [gru_row] + gru_bwd_rows
    torch.cuda.empty_cache()

    # every counter is read per path: reset just before it, read just after
    counters = {"lstm_fwd": lstm.lstm_fwd, "logz_fwd": logz.logz_fwd,
                "logz_posteriors": logz.logz_posteriors,
                "lstm_bwd_acts": lstm.lstm_bwd_acts,
                "lstm_bwd_fusedw": lstm.lstm_bwd_fusedw,
                "lstm_bwd_recompute": lstm.lstm_bwd_recompute,
                "crf_fwd": crf.crf_fwd, "crf_bwd": crf.crf_bwd,
                "gru_fwd": gru.gru_fwd,
                "gru_bwd_recompute": gru.gru_bwd_recompute,
                "gru_bwd_fusedw": gru.gru_bwd_fusedw}
    loss = ("crf_fwd", "crf_bwd", "logz_fwd", "logz_posteriors")
    lstm_bwds = {"acts": "lstm_bwd_acts", "pre": "lstm_bwd_fusedw",
                 "recompute": "lstm_bwd_recompute"}
    gru_bwds = {"recompute": "gru_bwd_recompute", "stored": "gru_bwd_fusedw"}
    lstm_call = ("lstm_fwd", "logz_fwd", "logz_posteriors")
    gru_call = ("gru_fwd", "logz_fwd", "logz_posteriors")

    def pick(names):
        return {k: counters[k] for k in names}

    def train_policy(model, fwd, bwds, policy, niter):
        """The training path under `policy`: its backward launched, the
        cell's other backwards (the default among them) not."""
        return train_path(torch, work, seed,
                          pick((fwd,) + loss + tuple(bwds.values())), model,
                          policy=policy, niter=niter,
                          idle=[v for k, v in bwds.items()
                                if k != policy[0]])[0]

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    launches = {}
    try:
        launches["mLstm training"], _, outdir = train_path(
            torch, work, seed, pick(("lstm_fwd", "lstm_bwd_acts") + loss),
            MLSTM)
        torch.cuda.empty_cache()
        for policy in LSTM_POLICIES[1:]:
            launches["mLstm training " + policy[0]] = train_policy(
                MLSTM, "lstm_fwd", lstm_bwds, policy, 4)
            torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MLSTM, LSTM_POLICIES[1:])
        model = os.path.join(outdir, "model_final.checkpoint")
        launches["mLstm basecall"], _, reads = main_path(
            torch, dev, seed, work, model, pick(lstm_call), "mLstm")
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MLSTM)
        torch.cuda.empty_cache()

        launches["mGru training"], _, _ = train_path(
            torch, work, seed, pick(("gru_fwd", "gru_bwd_recompute") + loss),
            MGRU)
        torch.cuda.empty_cache()
        launches["mGru training stored"] = train_policy(
            MGRU, "gru_fwd", gru_bwds, GRU_POLICIES[1], 4)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MGRU, GRU_POLICIES[1:])
        launches["mGru real reads"], _ = real_reads(torch, dev, work,
                                                    pick(gru_call))
        model = seeded_checkpoint(work, seed, MGRU)
        launches["mGru basecall"], _, reads = main_path(
            torch, dev, seed, work, model, pick(gru_call), "mGru")
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MGRU)
        torch.cuda.empty_cache()
        policies = policy_steps(torch, dev, seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("launches by path: {}".format(json.dumps(launches)))
    say("residual policies (training step, peak memory, one layer): "
        "{}".format(json.dumps({"{} {}".format(*k): v
                                for k, v in policies.items()})))
    for e, row in lstm_fwd_rows.items():
        say("lstm_fwd emit={} (training shape): {}".format(e, json.dumps(
            row)))
    for res, row in gru_fwd_rows.items():
        say("gru_fwd emit_residuals={} (mGru training shape): {}".format(
            res, json.dumps(row)))
    say("gru_fwd (H=96, the shipped remap model's width): {}".format(
        json.dumps({k: gru96_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "max_abs_err",
                                              "library_ms")})))
    say("crf at L={} (T={}, B={}): {}".format(LL, LT, LB, json.dumps(
        [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                            "max_abs_err")} for r in long_crf])))
    # the path each row's launches come from: kernels 1-3 the mLstm
    # basecall path, 4-6 the mLstm training path, 7 the mGru basecall path,
    # 8 the mGru training path, and 11-13 the training paths under the
    # residual switches
    source = {"lstm_fwd": "mLstm basecall", "logz_fwd": "mLstm basecall",
              "logz_posteriors": "mLstm basecall",
              "lstm_bwd_acts": "mLstm training", "crf_fwd": "mLstm training",
              "crf_bwd": "mLstm training", "gru_fwd": "mGru basecall",
              "gru_bwd_recompute": "mGru training",
              "lstm_bwd_fusedw": "mLstm training pre",
              "lstm_bwd_recompute": "mLstm training recompute",
              "gru_bwd_fusedw": "mGru training stored"}
    for k in kernels:
        k["launches"] = launches[source[k["name"]]][k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    check(len(kernels) == len(counters) == 11, "kernels line: {} rows".format(
        len(kernels)))
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1,
                        help="seed of weights, reads and test inputs")
    args = parser.parse_args()
    try:
        run(args.seed)
    except SmokeFailure as e:
        sys.stderr.write("chip_smoke FAILED: {}\n".format(e))
        sys.exit(1)


if __name__ == "__main__":
    main()
