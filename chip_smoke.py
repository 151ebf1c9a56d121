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
   (T=2000, B=256, H=D=256), both directions.
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
5. A `kernels` JSON line, the card line, and the result line
   {"ok": true, "device": {...}}.

Every kernel counter is set to 0 just before each path and read just
after.  Exits non-zero, printing no result line, if there is no card or
any phase fails.  Imports nothing of JAX.
"""

import argparse
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


def check_lstm_train(torch, dev, rng):
    """The forward with emit="acts" and the backward at the production
    training shape, both directions, against their twins; cuDNN's LSTM
    (torch.nn.LSTM) forward with grad and its backward as the library
    yardsticks."""
    from taiyaki_tpu_torch.ops import lstm
    D = H
    x = _tensor(torch, dev, rng.normal(size=(TT, TB, D)))
    iW = _tensor(torch, dev, rng.normal(size=(4 * H, D)) / np.sqrt(D))
    b = _tensor(torch, dev, 0.5 * rng.normal(size=4 * H))
    sW = _tensor(torch, dev, rng.normal(size=(4 * H, H)) / np.sqrt(H))
    dh = _tensor(torch, dev, rng.normal(size=(TT, TB, H)))
    f_err = b_err = 0.0
    f_ms, f_plain, b_ms, b_plain = {}, {}, {}, {}
    for reverse in (False, True):
        got = lstm.lstm_fwd(x, iW, b, sW, reverse=reverse, emit="acts")
        want = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                   emit="acts")
        torch.cuda.synchronize()
        f_err = max([f_err] + [max_abs_diff(g, w) for g, w in zip(got, want)])
        h, c, acts, tc = want
        args = (dh, acts, tc, lstm.prev_state(c, reverse), h, x, sW, iW)
        gk = lstm.lstm_bwd_acts(*args, reverse=reverse)
        gp = lstm.lstm_bwd_acts_plain(*args, reverse=reverse)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in gk),
              "lstm_bwd_acts: non-finite output")
        b_err = max([b_err, rel_err(gk[0], gp[0])]
                    + [rel_err(g.sum(0), w.sum(0))
                       for g, w in zip(gk[1:], gp[1:])])
        f_ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd(
            x, iW, b, sW, reverse=reverse, emit="acts"), reps=3)
        f_plain[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
            x, iW, b, sW, reverse=reverse, emit="acts"), reps=1)
        b_ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_bwd_acts(
            *args, reverse=reverse), reps=3)
        b_plain[reverse] = cuda_ms(torch, lambda: lstm.lstm_bwd_acts_plain(
            *args, reverse=reverse), reps=1)
        del got, want, gk, gp, args, h, c, acts, tc
    check(f_err <= 1e-4, "lstm_fwd(acts): max |err| {} > 1e-4".format(f_err))
    check(b_err <= 1e-4, "lstm_bwd_acts: max relative err {} > 1e-4".format(
        b_err))
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
    nbh = 4 * TT * TB * H
    f_bytes = 4 * (TT * TB * D + 4 * H * (D + H + 1)) + 4 * nbh + nbh
    f_flops = 2 * TT * TB * 4 * H * (D + H)
    f_bound, f_by = bound_ms(f_bytes, f_flops)
    b_bytes = (4 * nbh + nbh + 2 * 4 * TT * TB * D
               + 2 * 4 * 4 * H * (D + H) + 4 * 4 * H)
    b_flops = 2 * TT * TB * 4 * H * (2 * H + 2 * D)
    b_bound, b_by = bound_ms(b_bytes, b_flops)
    say("lstm_fwd(acts) T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), "
        "kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
        "torch.nn.LSTM forward with grad {:.3f} ms, bound {:.3f} ms "
        "({})".format(TT, TB, H, f_err, f_ms[False], f_ms[True],
                      f_plain[False], f_plain[True], lib_f, f_bound, f_by))
    say("lstm_bwd_acts T={} B={} D=H={}: max relative err {:.3g} (tol "
        "1e-4), kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
        "{:.3f} ms, torch.nn.LSTM backward {:.3f} ms, bound {:.3f} ms "
        "({})".format(TT, TB, H, b_err, b_ms[False], b_ms[True],
                      b_plain[False], b_plain[True], lib_b, b_bound, b_by))
    acts_row = dict(ms=f_ms[False], plain_ms=f_plain[False],
                    bound_ms=f_bound, max_abs_err=f_err, library_ms=lib_f)
    return acts_row, dict(
        name="lstm_bwd_acts", route="cuda",
        source="taiyaki_tpu_torch/csrc/lstm.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:385", max_abs_err=b_err,
        ms=b_ms[False], plain_ms=b_plain[False], bound_ms=b_bound,
        bound_by=b_by, library_ms=lib_b)


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
    """The GRU forward and the recomputing backward (kernel 8) at the mGru
    training shape (T=2000, B=256, H=D=256), both directions, against
    their twins; cuDNN's GRU forward with grad and its backward as the
    library yardsticks."""
    from taiyaki_tpu_torch.ops import gru
    x, iW, b, sW = _gru_inputs(torch, dev, rng, GT, TB, H, H)
    dh = _tensor(torch, dev, rng.normal(size=(GT, TB, H)))
    f_err = b_err = 0.0
    f_ms, f_plain, b_ms, b_plain = {}, {}, {}, {}
    for reverse in (False, True):
        got = gru.gru_fwd(x, iW, b, sW, reverse=reverse)
        h = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse)
        torch.cuda.synchronize()
        f_err = max(f_err, max_abs_diff(got, h))
        del got
        args = (dh, h, x, sW, iW, b)
        gk = gru.gru_bwd_recompute(*args, reverse=reverse)
        gp = gru.gru_bwd_recompute_plain(*args, reverse=reverse)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in gk),
              "gru_bwd_recompute: non-finite output")
        b_err = max([b_err, rel_err(gk[0], gp[0])]
                    + [rel_err(g.sum(0), w.sum(0))
                       for g, w in zip(gk[1:], gp[1:])])
        del gk, gp
        f_ms[reverse] = cuda_ms(torch, lambda: gru.gru_fwd(
            x, iW, b, sW, reverse=reverse), reps=3)
        f_plain[reverse] = cuda_ms(torch, lambda: gru.gru_fwd_plain(
            x, iW, b, sW, reverse=reverse), reps=1)
        b_ms[reverse] = cuda_ms(torch, lambda: gru.gru_bwd_recompute(
            *args, reverse=reverse), reps=3)
        b_plain[reverse] = cuda_ms(torch, lambda: gru.gru_bwd_recompute_plain(
            *args, reverse=reverse), reps=1)
        del args, h
        torch.cuda.empty_cache()
    check(f_err <= 1e-4, "gru_fwd (training shape): max |err| {} > 1e-4"
          .format(f_err))
    check(b_err <= 1e-4, "gru_bwd_recompute: max relative err {} > 1e-4"
          .format(b_err))
    ref = _torch_gru(torch, dev, x, iW, b, sW)
    xr = x.clone().requires_grad_()
    lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
    out = ref(xr)[0]
    lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=3)
    del out, xr, ref
    f_bound, f_by = _gru_fwd_bound(GT, TB, H, H)
    # gx and gh rebuilt, the dh chain, d_x, d_iW, d_sW: six products
    b_bound, b_by = bound_ms(
        4 * (4 * GT * TB * H + 2 * 3 * H * 2 * H + 2 * 3 * H),
        6 * 2 * GT * TB * 3 * H * H)
    say("gru_fwd    T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), kernel "
        "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
        "torch.nn.GRU forward with grad {:.3f} ms, bound {:.3f} ms "
        "({})".format(GT, TB, H, f_err, f_ms[False], f_ms[True],
                      f_plain[False], f_plain[True], lib_f, f_bound, f_by))
    say("gru_bwd_recompute T={} B={} D=H={}: max relative err {:.3g} (tol "
        "1e-4), kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
        "{:.3f} ms, torch.nn.GRU backward {:.3f} ms, bound {:.3f} ms "
        "({})".format(GT, TB, H, b_err, b_ms[False], b_ms[True],
                      b_plain[False], b_plain[True], lib_b, b_bound, b_by))
    fwd_row = dict(ms=f_ms[False], plain_ms=f_plain[False], bound_ms=f_bound,
                   max_abs_err=f_err, library_ms=lib_f)
    return fwd_row, dict(
        name="gru_bwd_recompute", route="cuda",
        source="taiyaki_tpu_torch/csrc/gru.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:1311", max_abs_err=b_err,
        ms=b_ms[False], plain_ms=b_plain[False], bound_ms=b_bound,
        bound_by=b_by, library_ms=lib_b)


# -- phases 3 and 4 ----------------------------------------------------------

def train_path(torch, work, seed, counters, model):
    """The training CLI on the card with the model file of `model` (name,
    path, stride) at size 256; returns (launches, stats, outdir)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    name, model_py, stride = model
    outdir = os.path.join(work, "train_" + name)
    for fn in counters.values():
        fn.launches = 0
    stats = train_flipflop.main([
        "--size", str(H), "--stride", str(stride), "--winlen", "19",
        "--chunk_len_min", str(CHUNK), "--chunk_len_max", str(CHUNK),
        "--min_sub_batch_size", str(TB), "--niteration", "8",
        "--warmup_batches", "2", "--save_every", "4",
        "--sample_nreads_before_filtering", "1000",
        "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
        "--outdir", outdir, model_py, READS_HDF5])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check(n > 0, "{} training path never launched kernel {}".format(
            name, k))
    with open(os.path.join(outdir, "batch.log")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    check(len(losses) == 8 and all(np.isfinite(losses)),
          "{} batch.log losses {}".format(name, losses))
    for ckpt in ("model_checkpoint_00001", "model_checkpoint_00002",
                 "model_final"):
        check(os.path.exists(os.path.join(outdir, ckpt + ".checkpoint")),
              "no checkpoint {}".format(ckpt))
    say("training path ({} {}/{}/19, chunk {}, {} chunks, 8 iterations): "
        "losses {}; {:.3f} s in the loop (validation and checkpoints "
        "included): {:.4f} steps/s, {:.2f} trained ksample/s; launches "
        "{}".format(name, H, stride, CHUNK, TB,
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


def card_vs_cpu(torch, dev, seed, model):
    """One training step's loss and gradients on the card and on the CPU
    twins, same batch and weights, full width, 8 chunks.  Tolerances: loss
    1e-5 relative (f32 sums in another order through 800 or 2000 steps
    of 5 recurrent layers and the lattice); each gradient 1e-5 of its
    tensor's largest value."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    batch, kwargs = step_batch(seed, 8, model)
    res = []
    for device in (dev, torch.device("cpu")):
        net = new_net(seed, kwargs, device, model)
        t0 = time.perf_counter()
        loss, grads = train.make_grad_step(net)(
            train.batch_to_device(batch, device), 1.0)
        res.append((float(loss), [g.cpu() for g in grads],
                    time.perf_counter() - t0))
    (lc, gc, tc), (lp, gp, tp) = res
    l_err = abs(lc - lp) / max(1.0, abs(lp))
    errs = [rel_err(a, b) for a, b in zip(gc, gp)]
    g_err = max(errs)
    worst = leaf_names(net)[int(np.argmax(errs))]
    check(l_err <= 1e-5, "card vs CPU ({}): loss {} vs {}".format(
        model[0], lc, lp))
    check(g_err <= 1e-5, "card vs CPU ({}): gradient err {} ({})".format(
        model[0], g_err, worst))
    say("card vs CPU, one {} step (8 chunks x {} samples, size {}): loss "
        "{} vs {} (relative err {:.3g}, tol 1e-5); {} gradients, largest "
        "relative err {:.3g} in {} (tol 1e-5); CPU twins {:.1f} s".format(
            model[0], CHUNK, H, lc, lp, l_err, len(gc), g_err, worst, tp))


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
    acts_row, bwd_row = check_lstm_train(torch, dev, rng)
    kernels += [bwd_row] + check_crf(torch, dev, rng)
    torch.cuda.empty_cache()
    long_crf = check_crf(torch, dev, rng, LT, LB, LL, g_tol=3e-4)
    torch.cuda.empty_cache()
    gru_row, gru96_row = check_gru(torch, dev, rng)
    gru_train_row, gru_bwd_row = check_gru_train(torch, dev, rng)
    kernels += [gru_row, gru_bwd_row]
    torch.cuda.empty_cache()

    # every counter is read per path: reset just before it, read just after
    counters = {"lstm_fwd": lstm.lstm_fwd, "logz_fwd": logz.logz_fwd,
                "logz_posteriors": logz.logz_posteriors,
                "lstm_bwd_acts": lstm.lstm_bwd_acts, "crf_fwd": crf.crf_fwd,
                "crf_bwd": crf.crf_bwd, "gru_fwd": gru.gru_fwd,
                "gru_bwd_recompute": gru.gru_bwd_recompute}
    lstm_train = ("lstm_fwd", "lstm_bwd_acts", "crf_fwd", "crf_bwd",
                  "logz_fwd", "logz_posteriors")
    gru_train = ("gru_fwd", "gru_bwd_recompute", "crf_fwd", "crf_bwd",
                 "logz_fwd", "logz_posteriors")
    lstm_call = ("lstm_fwd", "logz_fwd", "logz_posteriors")
    gru_call = ("gru_fwd", "logz_fwd", "logz_posteriors")

    def pick(names):
        return {k: counters[k] for k in names}

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    launches = {}
    try:
        launches["mLstm training"], _, outdir = train_path(
            torch, work, seed, pick(lstm_train), MLSTM)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MLSTM)
        model = os.path.join(outdir, "model_final.checkpoint")
        launches["mLstm basecall"], _, reads = main_path(
            torch, dev, seed, work, model, pick(lstm_call), "mLstm")
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MLSTM)
        torch.cuda.empty_cache()

        launches["mGru training"], _, _ = train_path(
            torch, work, seed, pick(gru_train), MGRU)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MGRU)
        launches["mGru real reads"], _ = real_reads(torch, dev, work,
                                                    pick(gru_call))
        model = seeded_checkpoint(work, seed, MGRU)
        launches["mGru basecall"], _, reads = main_path(
            torch, dev, seed, work, model, pick(gru_call), "mGru")
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MGRU)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("launches by path: {}".format(json.dumps(launches)))
    say("lstm_fwd emit=acts (training shape): {}".format(json.dumps(
        acts_row)))
    say("gru_fwd (mGru training shape): {}".format(json.dumps(
        gru_train_row)))
    say("gru_fwd (H=96, the shipped remap model's width): {}".format(
        json.dumps({k: gru96_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "max_abs_err",
                                              "library_ms")})))
    say("crf at L={} (T={}, B={}): {}".format(LL, LT, LB, json.dumps(
        [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                            "max_abs_err")} for r in long_crf])))
    # the path each row's launches come from: kernels 1-3 the mLstm
    # basecall path (slice 1), 4-6 the mLstm training path (slice 2),
    # 7 the mGru basecall path and 8 the mGru training path (this slice)
    source = {"lstm_fwd": "mLstm basecall", "logz_fwd": "mLstm basecall",
              "logz_posteriors": "mLstm basecall",
              "lstm_bwd_acts": "mLstm training", "crf_fwd": "mLstm training",
              "crf_bwd": "mLstm training", "gru_fwd": "mGru basecall",
              "gru_bwd_recompute": "mGru training"}
    for k in kernels:
        k["launches"] = launches[source[k["name"]]][k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
