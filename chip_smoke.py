#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (taiyaki_tpu_torch) on one NVIDIA
card; run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

1. Card: name and power limit; builds the CUDA kernels from csrc/.
2. Kernels: each against its plain PyTorch twin on the card, with its time
   (CUDA events), the twin's time, one PyTorch call computing the same
   function where there is one, and its bound.  Basecall kernels at the
   basecall path's shapes (T=1000 blocks, B=128 chunks, H=256, S=40);
   training kernels at the production training shape (T=800 blocks,
   B=256 chunks, H=D=256, L=512 lattice positions, S=40): the LSTM
   forward with its backward residuals, the LSTM backward (both
   directions) and the CRF forward and backward.
3. Training path: `taiyaki_tpu_torch.cli.train_flipflop` on the card, on
   the repo's mapped reads (RESULTS/training_ingredients/
   mapped_remap_samref.hdf5), mLstm_flipflop 256/5/19, chunk 4000,
   256 chunks per batch, 8 iterations: every loss finite, checkpoints
   written, every kernel of the path launched.
4. Card against CPU: one training step (loss and every gradient) on the
   same batch and seeded weights at full width, 8 chunks.
5. Basecall path: the trained checkpoint of phase 3 calls synthetic fast5
   reads (8 x 100k samples and one read shorter than a chunk) through
   `taiyaki_tpu_torch.cli.basecall` with its defaults, fasta and fastq.
   Two reads are called again on the CPU: the calls must be equal, or,
   where a Viterbi tie flips a base, the card's path must score the CPU's
   best score within 1e-4 under the CPU's scores.
6. Profiles: stage wall times and device time by kernel of one basecall
   batch and of one training step (torch.profiler).
7. A `kernels` JSON line, the card line, and the result line
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result line, if there is no card or any phase
fails.  Imports nothing of JAX.
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
ROOT = os.path.dirname(os.path.abspath(__file__))
READS_HDF5 = os.path.join(ROOT, "RESULTS", "training_ingredients",
                          "mapped_remap_samref.hdf5")


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


def check_crf(torch, dev, rng):
    """The CRF forward and backward at the production training shape
    against their twins (no PyTorch call computes either)."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import crf, flipflop
    lp = _tensor(torch, dev, rng.normal(size=(TT, TB, S)))
    seqlens = rng.integers(TL // 2, TL + 1, size=TB).astype(np.int32)
    seqs = np.zeros((TB, TL), np.int32)
    for i in range(TB):
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
    check(s_err <= s_tol, "crf_fwd: score err {} > {}".format(s_err, s_tol))
    check(l_err <= 1e-4, "crf_fwd: lattice err {} > 1e-4".format(l_err))
    check(g_err <= 1e-5, "crf_bwd: max |err| {} > 1e-5".format(g_err))
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
    idx_bytes = 4 * 6 * TB * TL
    f_bound, f_by = bound_ms(4 * (TT * TB * S + TT * TB * TL + TB * TL + TB)
                             + idx_bytes, 10 * TT * npos)
    b_bound, b_by = bound_ms(4 * (2 * TT * TB * S + TT * TB * TL)
                             + idx_bytes, 20 * TT * npos)
    say("crf_fwd T={} B={} L={} S={}: score err {:.3g} (tol {:.3g}), "
        "lattice {:.3g} (tol 1e-4), kernel {:.3f} ms, plain {:.3f} ms, "
        "bound {:.4f} ms ({})".format(TT, TB, TL, S, s_err, s_tol, l_err,
                                      f_ms, f_plain, f_bound, f_by))
    say("crf_bwd: d lp max |err| {:.3g} (tol 1e-5), run to run {:.3g} (tol "
        "1e-6), kernel {:.3f} ms, plain {:.3f} ms, bound {:.4f} ms "
        "({})".format(g_err, g_rerun, b_ms, b_plain, b_bound, b_by))
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


# -- phases 3 and 4 ----------------------------------------------------------

def train_path(torch, work, seed, counters):
    """The training CLI on the card; returns (launches, stats, outdir)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    outdir = os.path.join(work, "train")
    model_py = os.path.join(ROOT, "taiyaki_tpu_torch", "models",
                            "mLstm_flipflop.py")
    for fn in counters.values():
        fn.launches = 0
    stats = train_flipflop.main([
        "--size", str(H), "--stride", "5", "--winlen", "19",
        "--chunk_len_min", "4000", "--chunk_len_max", "4000",
        "--min_sub_batch_size", str(TB), "--niteration", "8",
        "--warmup_batches", "2", "--save_every", "4",
        "--sample_nreads_before_filtering", "1000",
        "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
        "--outdir", outdir, model_py, READS_HDF5])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        check(n > 0, "training path never launched kernel {}".format(name))
    with open(os.path.join(outdir, "batch.log")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    check(len(losses) == 8 and all(np.isfinite(losses)),
          "batch.log losses {}".format(losses))
    for name in ("model_checkpoint_00001", "model_checkpoint_00002",
                 "model_final"):
        check(os.path.exists(os.path.join(outdir, name + ".checkpoint")),
              "no checkpoint {}".format(name))
    say("training path (mLstm_flipflop {}/5/19, chunk 4000, {} chunks, 8 "
        "iterations): losses {}; {:.3f} s in the loop (validation and "
        "checkpoints included): {:.4f} steps/s, {:.2f} trained ksample/s; "
        "launches {}".format(
            H, TB, ", ".join("{:.5f}".format(v) for v in losses),
            stats["seconds"], stats["iterations"] / stats["seconds"],
            stats["samples"] / stats["seconds"] / 1e3, launches))
    return launches, stats, outdir


def step_batch(seed, nchunk):
    """A seeded batch of nchunk 4000-sample chunks from the repo's reads,
    and the mLstm_flipflop factory kwargs."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    with mapped_signal_files.MappedSignalReader(READS_HDF5) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = chunk_selection.sample_filter_parameters(
        reads, 200, 4000, 3.0, 10.0, 0.5, 5, 1.1)
    batch, _ = train.sample_batch(reads, 4000, nchunk,
                                  train.max_seqlen_for_chunk(4000, 5),
                                  alphabet, fp, seqlen_granularity=128)
    return batch, dict(insize=1, size=H, winlen=19, stride=5,
                       alphabet_info=alphabet)


def new_net(seed, kwargs, device):
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    model_py = os.path.join(ROOT, "taiyaki_tpu_torch", "models",
                            "mLstm_flipflop.py")
    net, _, _ = helpers.new_model(model_py, **kwargs)
    params = net.init(np.random.default_rng(seed))
    return load_jax_params(net, params).to(device)


def card_vs_cpu(torch, dev, seed):
    """One training step's loss and gradients on the card and on the CPU
    twins, same batch and weights, full width, 8 chunks.  Tolerances: loss
    1e-5 relative (f32 sums in another order through 800 steps of 5
    recurrent layers and the lattice); each gradient 1e-5 of its
    tensor's largest value."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    batch, kwargs = step_batch(seed, 8)
    res = []
    for device in (dev, torch.device("cpu")):
        net = new_net(seed, kwargs, device)
        loss, grads = train.make_grad_step(net)(
            train.batch_to_device(batch, device), 1.0)
        res.append((float(loss), [g.cpu() for g in grads]))
    (lc, gc), (lp, gp) = res
    l_err = abs(lc - lp) / max(1.0, abs(lp))
    errs = [rel_err(a, b) for a, b in zip(gc, gp)]
    g_err = max(errs)
    worst = leaf_names(net)[int(np.argmax(errs))]
    check(l_err <= 1e-5, "card vs CPU: loss {} vs {}".format(lc, lp))
    check(g_err <= 1e-5, "card vs CPU: gradient err {} ({})".format(
        g_err, worst))
    say("card vs CPU, one step (8 chunks x 4000 samples, size {}): loss {} "
        "vs {} (relative err {:.3g}, tol 1e-5); {} gradients, largest "
        "relative err {:.3g} in {} (tol 1e-5)".format(
            H, lc, lp, l_err, len(gc), g_err, worst))


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
    chunks = np.concatenate([basecall.prepare_read(
        rid, basecall.get_signal(wanted[rid], rid), T * 5, 100 * 5, None,
        False)["chunks"] for rid in read_ids], axis=1)
    res = []
    for device in (dev, torch.device("cpu")):
        net, params, *_ = helpers.load_model(model)
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


def main_path(torch, dev, seed, work, model, counters):
    """Basecall synthetic reads with the checkpoint `model` through the
    basecall CLI on the card; returns (launches, stats, reads dir)."""
    from taiyaki_tpu_torch.cli import basecall
    rng = np.random.default_rng(seed)
    reads = os.path.join(work, "reads")
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
    fa = os.path.join(work, "calls.fa")
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
    say("basecall path (fasta, defaults): {} reads, {} samples, {} bases in "
        "{:.3f} s: {:.3f} reads/s, {:.3f} ksample/s, {:.3f} kbase/s; "
        "launches {}".format(
            stats["ncalled"], stats["nsample"], stats["nbase"],
            stats["seconds"], stats["ncalled"] / stats["seconds"],
            stats["nsample"] / stats["seconds"] / 1e3,
            stats["nbase"] / stats["seconds"] / 1e3, launches))

    fq = os.path.join(work, "calls.fq")
    stats_q = basecall.main(["--output", fq, "--quiet", "--fastq", reads,
                             model])
    with open(fq) as fh:
        lines = fh.read().splitlines()
    check(len(lines) == 4 * len(calls), "fastq: {} lines".format(len(lines)))
    for i in range(0, len(lines), 4):
        check(lines[i + 1] == calls[lines[i][1:]]
              and len(lines[i + 3]) == len(lines[i + 1]),
              "fastq call of {} differs from fasta".format(lines[i][1:]))
    say("basecall path (fastq): {} reads in {:.3f} s: {:.3f} ksample/s".format(
        stats_q["ncalled"], stats_q["seconds"],
        stats_q["nsample"] / stats_q["seconds"] / 1e3))

    cpu_fa = os.path.join(work, "cpu.fa")
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


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_batch(torch, dev, model, reads_dir):
    """Where one 128-chunk batch of the main path spends its time: host
    wall time of each stage (synchronised), then torch.profiler's device
    time by kernel and the device's busy share over the batch."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.ops import decode
    from taiyaki_tpu_torch.utils import helpers
    parts = []
    for fname, rid in fast5utils.iterate_fast5_reads(reads_dir):
        parts.append(basecall.prepare_read(
            rid, basecall.get_signal(fname, rid), T * 5, 100 * 5, None,
            False)["chunks"])
    chunks = np.concatenate(parts, axis=1)[:, :B]
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
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
            B, T * 5, ", ".join("{} {:.3f}".format(k, v)
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


def profile_train_step(torch, dev, seed):
    """Where one training step (256 chunks x 4000 samples) spends its
    time: synchronised wall time of each stage (forward by layer, CRF
    loss, logZ, backward, clip + optimizer), then device time by kernel."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.ops import flipflop as ffops
    batch, kwargs = step_batch(seed, TB)
    net = new_net(seed, kwargs, dev)
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
    say("training step of {} chunks x 4000 samples, stage wall times (ms, "
        "synchronised): {} ; total {:.3f} ms".format(
            TB, ", ".join("{} {:.3f}".format(k, v)
                          for k, v in walls.items()), total))
    say_profile("one training step", kern, wall, total)


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
    from taiyaki_tpu_torch.ops import crf, cuda_lib, logz, lstm

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

    # every counter is read per path: reset just before it, read just after
    counters = {"lstm_fwd": lstm.lstm_fwd, "logz_fwd": logz.logz_fwd,
                "logz_posteriors": logz.logz_posteriors,
                "lstm_bwd_acts": lstm.lstm_bwd_acts, "crf_fwd": crf.crf_fwd,
                "crf_bwd": crf.crf_bwd}
    basecall_kernels = ("lstm_fwd", "logz_fwd", "logz_posteriors")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train_launches, _, outdir = train_path(torch, work, seed, counters)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed)
        model = os.path.join(outdir, "model_final.checkpoint")
        call_launches, _, reads = main_path(
            torch, dev, seed, work, model,
            {k: counters[k] for k in basecall_kernels})
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("launches: training path {}; basecall path {}".format(
        train_launches, call_launches))
    say("lstm_fwd emit=acts (training shape): {}".format(json.dumps(
        acts_row)))
    # kernels 1-3 report the basecall path (slice 1), kernels 4-6 the
    # training path (this slice)
    for k in kernels:
        k["launches"] = (call_launches[k["name"]]
                         if k["name"] in basecall_kernels
                         else train_launches[k["name"]])
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
