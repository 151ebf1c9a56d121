"""The CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA card with nvcc (sm_90a) and skip elsewhere.  The file
imports no JAX, so it runs on a machine with only PyTorch and CUDA:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: LSTM h (and c, acts, tanh c) atol 1e-4 (f32 sums in another
order, carried through the recurrence); LSTM backward 1e-4 relative to
the largest value of each output (sums of up to T*B products in another
order; the same for the backwards from stored pre and rebuilding pre);
logZ rtol 1e-5 / atol 1e-3 over T up to 4000 (the forward's segment sums
added in segment order, bitwise the same with or without the lattice);
lattices atol 1e-4;
posteriors atol 1e-5 (their kernels cut T into segments; T of one step,
of one segment and one step more, a batch of one); the CRF score 1e-3 +
1e-5 |score| and its gradient atol 1e-5 (posteriors, each in [0, 1]; 3e-4
over lattices of thousands of steps, see CRF_SHAPES), bitwise equal from
run to run (its sums are taken in an order fixed by the row's indices,
no atomics), and the forward's lattice bitwise equal from run to run; GRU h atol 1e-4 and its backward 1e-4
relative, as the LSTM's (gh and gx of the forward atol 1e-4, as h).
A retained graph gives bitwise the same gradients twice.  The CRF on
score streams (kernels 9-10): the same score and lattice tolerances, its
posteriors atol 1e-5 (3e-4 over lattices of thousands of steps, as the
fused kernels' gradient), bitwise equal from run to run (no atomics); the
gradient scattered from them against the fused kernels' 1e-5, 1e-6 from
run to run (scatter_add_'s atomics); the route's d lp entry
(crf_grad_streams) 1e-5 of its twin's largest entry and bitwise from run
to run; at every band edge of the streams' chains, past 8192 positions
(clusters of CTAs) and past 32768 (their device-memory instance) the long
lattices' tolerances.  The recurrences
on given gates (kernels 14-17, ops/rnn.py's lstm_scan and gru_scan) as
the layer kernels: outputs 1e-4, backwards 1e-4 relative, also against
the whole layers through autograd.  The LSTM and GRU forwards also at
the remap path's shapes (B=8 whole reads of T=8192 blocks; the mLstm 256
and the shipped remap model's widths), at the layers' 1e-4.  The shapes
include H=384, the JAX
trainer's default size, on a batch that is not a multiple of 8.  The
forward recurrences' cluster instance (the plan's choice at every width
below ~450) against the forced L2 instance: 1e-4 (it sums over k in
slices; the L2 instance, still taken at H=512, in one chain).  The
backward chains' cluster instance against its twins and the forced L2
instance: 1e-4 relative, as the backwards (each unit's partials summed
in rank order).  The two GEMMs (ops/gemm.py), each instance: within
1e-5 of the largest output of their twins (torch.matmul on the card,
TF32 off) and of an f64 product (3xTF32 drops 2^-22 of a product; the
f32 sums over slices of up to 51,200 rows stay under 1e-5 of the
largest), the atb partials bitwise equal from run to run.
"""

import math

import numpy as np
import pytest
import torch

from taiyaki_tpu_torch.ops import crf, gemm, gru, lstm, logz, rnn, rnn_plan

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lstm_inputs(T, B, D, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (rng.normal(size=(4 * H, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.5 * rng.normal(size=4 * H)).astype(np.float32)
    sW = (rng.normal(size=(4 * H, H)) / np.sqrt(H)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, iW, b, sW)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(37, 13, 7, 16), (5, 3, 300, 40),
                                   (200, 128, 256, 256), (120, 37, 384, 384)])
def test_lstm_kernel_matches_twin(dev, shape, reverse):
    args = _lstm_inputs(*shape)
    want = lstm.lstm_fwd_plain(*[a.to(dev) for a in args], reverse=reverse)
    n = lstm.lstm_fwd.launches
    got = lstm.lstm_fwd(*[a.to(dev) for a in args], reverse=reverse)
    torch.cuda.synchronize()
    assert lstm.lstm_fwd.launches == n + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4


def test_lstm_kernel_rejects_bad_input(dev):
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(4, 2, 3, 8))
    with pytest.raises(ValueError, match="float32"):
        lstm.lstm_fwd(x.double(), iW, b, sW)
    with pytest.raises(ValueError, match="contiguous"):
        lstm.lstm_fwd(x.transpose(0, 1), iW, b, sW)


def _scores(T, B, nbase, seed=1):
    rng = np.random.default_rng(seed)
    S = 2 * nbase * (nbase + 1)
    return torch.from_numpy(
        (5.0 * np.tanh(rng.normal(size=(T, B, S)))).astype(np.float32))


# the segmented forward and posteriors: T = 1, T of one segment and one
# step past it, B = 1, nbase 1 to 8, the basecall and training shapes and
# T=4000, B=64
@pytest.mark.parametrize("shape", [(37, 13, 4), (50, 5, 2), (50, 5, 3),
                                   (1000, 128, 4), (1, 5, 4), (16, 3, 4),
                                   (17, 3, 4), (37, 1, 4), (800, 256, 4),
                                   (41, 3, 1), (40, 2, 5), (33, 3, 8),
                                   (4000, 64, 4)])
def test_logz_kernels_match_twins(dev, shape):
    T, B, nbase = shape
    s = _scores(T, B, nbase).to(dev)
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase)
    p0 = logz.logz_posteriors_plain(s, l0, nbase)
    nf = logz.logz_fwd.launches
    f1, z1, l1 = logz.logz_fwd(s)
    n = logz.logz_posteriors.launches
    p1 = logz.logz_posteriors(s, l1)
    f2, z2, none = logz.logz_fwd(s, emit_lattice=False)
    _, z3, l3 = logz.logz_fwd(s)
    torch.cuda.synchronize()
    assert logz.logz_posteriors.launches == n + logz.posterior_kernels(
        T, B, nbase)
    assert logz.logz_fwd.launches == nf + 3 * logz.forward_kernels(
        T, B, nbase)
    assert none is None and torch.equal(f1, f2)
    assert torch.equal(z1, z3) and torch.equal(l1, l3)
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-3)
    assert torch.equal(z1, z2)
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-4)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)
    torch.testing.assert_close(p1, p0, rtol=0, atol=1e-5)


def test_logz_posteriors_repeat_bit_for_bit(dev):
    s = _scores(300, 7, 4).to(dev)
    _, _, lat = logz.logz_fwd(s)
    assert torch.equal(logz.logz_posteriors(s, lat),
                       logz.logz_posteriors(s, lat))


def test_logz_posteriors_reject_bad_input(dev):
    s = _scores(20, 4, 4).to(dev)
    _, _, lat = logz.logz_fwd(s)
    with pytest.raises(ValueError, match="cpu"):
        logz.logz_posteriors(s, lat.cpu())
    with pytest.raises(ValueError, match="float32"):
        logz.logz_posteriors(s, lat.double())
    with pytest.raises(ValueError, match="shape"):
        logz.logz_posteriors(s, lat[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        logz.logz_posteriors(s.transpose(0, 1).contiguous().transpose(0, 1),
                             lat)
    # a contiguous view at an odd float offset runs (4-byte loads) and
    # gives the aligned call's posteriors
    off = torch.empty(s.numel() + 1, device=dev)[1:].view(s.shape)
    off.copy_(s)
    torch.testing.assert_close(logz.logz_posteriors(off, lat),
                               logz.logz_posteriors(s, lat), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="nbase"):
        logz.logz_posteriors(torch.zeros(3, 2, 2 * 9 * 10, device=dev),
                             torch.zeros(3, 2, 18, device=dev))


def test_logz_no_path_row_on_card(dev):
    s = _scores(20, 4, 4)
    s[:, 2] = -math.inf
    s = s.to(dev)
    _, z, lat = logz.logz_fwd(s)
    p = logz.logz_posteriors(s, lat)
    torch.cuda.synchronize()
    assert z[2].item() == -math.inf
    assert not torch.isnan(p).any()
    assert (p[:, 2] == 0).all()


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


# the last at the JAX trainer's default --size 384, on a batch that is
# not a multiple of 8
LSTM_SHAPES = [(37, 13, 7, 16), (5, 3, 300, 40), (800, 256, 256, 256),
               (120, 37, 384, 384)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_acts_kernel_matches_twin(dev, shape, reverse):
    args = [a.to(dev) for a in _lstm_inputs(*shape)]
    want = lstm.lstm_fwd_plain(*args, reverse=reverse, emit="acts")
    n = lstm.lstm_fwd.launches
    got = lstm.lstm_fwd(*args, reverse=reverse, emit="acts")
    torch.cuda.synchronize()
    assert lstm.lstm_fwd.launches == n + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() < 1e-4


def _lstm_bwd_inputs(shape, reverse, dev):
    T, B, D, H = shape
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(*shape))
    h, c, acts, tc = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                         emit="acts")
    rng = np.random.default_rng(3)
    dh = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32))
    return (dh.to(dev), acts, tc, lstm.prev_state(c, reverse), h, x, sW, iW)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_bwd_kernel_matches_twin(dev, shape, reverse):
    args = _lstm_bwd_inputs(shape, reverse, dev)
    want = lstm.lstm_bwd_acts_plain(*args, reverse=reverse)
    n = lstm.lstm_bwd_acts.launches
    got = lstm.lstm_bwd_acts(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm.lstm_bwd_acts.launches == n + 1
    assert got[0].shape == want[0].shape
    assert _rel_err(got[0], want[0]) < 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert g.shape[1:] == w.shape[1:]
        assert _rel_err(g.sum(0), w.sum(0)) < 1e-4


def _crf_inputs(T, B, L, seed=2, nmod=0, dev="cpu", wmax=1.0):
    """Scores, lattice index vectors of random sequences with ragged
    lengths (row 1 empty, row 2 longer than T allows: no path); with nmod,
    mod weights in [0.1, wmax)."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    rng = np.random.default_rng(seed)
    S = 40 + (1 + nmod if nmod else 0)
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    seqlens = rng.integers(1, min(L, T) + 1, size=B).astype(np.int32)
    seqlens[1] = 0
    if B > 2 and L > T + 1:
        seqlens[2] = T + 2
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = mf = None
    if nmod:
        mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1))
                              .astype(np.int32))
        mf = torch.from_numpy(rng.uniform(0.1, wmax, size=(B, L - 1))
                              .astype(np.float32))
    idx = flipflop._lattice_inputs(stay, move, torch.from_numpy(seqlens), S,
                                   mm, mf)
    return [lp.to(dev)] + [t.to(dev) for t in idx]


def _lattice_close(got, want, atol):
    live = want > crf.NEG / 2
    assert (got[~live] <= crf.NEG / 2).all()
    return (got[live] - want[live]).abs().max().item() <= atol


# (T, B, L, mod columns, gradient atol); L = 37 and 45 make lattice rows
# the backward cannot copy 16 bytes at a time, and S = 47 lp rows of 188
# bytes.  Over the long lattices (T of
# 4000 and 7000 steps) the log-space forward and backward lattices and the
# score of kernel and twin each drift apart by up to their 1e-4
# tolerance, so a posterior p = exp(fwd + bwd - score) moves by at most
# 3e-4 p, and a gradient entry sums posteriors of total at most 1: the
# gradient is held to 3e-4 there.
# The forward's bands (csrc/crf.cu TT_FWD_BANDS) change layout past 64,
# 1024, 2048 and 4096 positions: each edge and one past it.
CRF_SHAPES = [(37, 5, 12, 0, 1e-5), (41, 9, 300, 0, 1e-5),
              (30, 6, 20, 3, 1e-5), (800, 256, 512, 0, 1e-5),
              (4000, 6, 3712, 0, 3e-4), (7000, 3, 8192, 0, 3e-4),
              (50, 7, 37, 0, 1e-5), (60, 5, 45, 6, 1e-5),
              (40, 9, 64, 0, 1e-5), (40, 9, 65, 0, 1e-5),
              (300, 4, 1024, 0, 1e-5), (300, 4, 1025, 0, 1e-5),
              (300, 4, 2048, 0, 1e-5), (300, 4, 2049, 0, 1e-5),
              (300, 3, 4096, 0, 1e-5), (300, 3, 4097, 0, 1e-5)]


@pytest.mark.parametrize("shape", CRF_SHAPES)
def test_crf_kernels_match_twins(dev, shape):
    T, B, L, nmod, g_tol = shape
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        T, B, L, nmod=nmod, dev=dev)
    f0, s0, lat0 = crf.crf_fwd_plain(lp, sidx, midx, mmidx, mfact, valid)
    g0 = crf.crf_bwd_plain(lp, sidx, midx, mmidx, mfact, lat0, valid, last)
    nf, nb = crf.crf_fwd.launches, crf.crf_bwd.launches
    f1, s1, lat1 = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    g1 = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat1, valid, last)
    g2 = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat1, valid, last)
    _, s3, none = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid,
                              emit_lattice=False)
    f4, s4, lat4 = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    torch.cuda.synchronize()
    assert (crf.crf_fwd.launches, crf.crf_bwd.launches) == (nf + 3, nb + 2)
    assert none is None and torch.equal(s1, s3)
    assert torch.equal(lat1, lat4) and torch.equal(f1, f4) \
        and torch.equal(s1, s4)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4)
    assert _lattice_close(f1, f0, 1e-4)
    assert torch.isfinite(g1).all()
    assert (g1[:, 1] == 0).all()            # the empty row
    torch.testing.assert_close(g1, g0, rtol=0, atol=g_tol)
    assert torch.equal(g1, g2)


def test_crf_bwd_catmod_weights_match_twin(dev):
    """Kernel 6 and the streams route (kernels 9-10 and the scatter) at
    the cat_mod width with weights up to 8 (the --mod_factor ramp's
    start): a mod column's gradient sums posteriors times their weight,
    so both are held to 1e-5 times the largest weight."""
    from taiyaki_tpu_torch.ops import flipflop
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        800, 32, 512, nmod=6, dev=dev, wmax=8.0)
    _, _, lat0 = crf.crf_fwd_plain(lp, sidx, midx, mmidx, mfact, valid)
    g0 = crf.crf_bwd_plain(lp, sidx, midx, mmidx, mfact, lat0, valid, last)
    _, _, lat1 = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    g1 = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat1, valid, last)
    stay, move = flipflop._select_streams(lp, sidx, midx, mmidx, mfact)
    _, _, lat_s = crf.crf_fwd_streams(stay, move, valid)
    post = crf.crf_bwd_posteriors(stay, move, lat_s, valid, last)
    g_route = flipflop._scatter_posteriors(lp.shape, *post, sidx, midx,
                                           mmidx, mfact)
    atol = 1e-5 * mfact.max().item()
    f0, s0, _ = crf.crf_fwd_plain(lp, sidx, midx, mmidx, mfact, valid)
    f1, s1, _ = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4) and _lattice_close(f1, f0, 1e-4)
    torch.testing.assert_close(g1, g0, rtol=0, atol=atol)
    torch.testing.assert_close(g_route, g0, rtol=0, atol=atol)
    assert torch.equal(g1, crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat1,
                                       valid, last))


def test_crf_bwd_rejects_bad_input(dev):
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        20, 4, 12, dev=dev)
    _, _, lat = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    idx = (sidx, midx, mmidx, mfact)
    with pytest.raises(ValueError, match="cpu"):
        crf.crf_bwd(lp, *idx, lat.cpu(), valid, last)
    with pytest.raises(ValueError, match="float32"):
        crf.crf_bwd(lp, *idx, lat.double(), valid, last)
    with pytest.raises(ValueError, match="int32"):
        crf.crf_bwd(lp, *idx, lat, valid, last.long())
    with pytest.raises(ValueError, match="shape"):
        crf.crf_bwd(lp, *idx, lat[:, :3].contiguous(), valid, last)
    with pytest.raises(ValueError, match="contiguous"):
        crf.crf_bwd(lp, *idx, lat.transpose(0, 1).contiguous()
                    .transpose(0, 1), valid, last)
    with pytest.raises(ValueError, match="beyond"):
        crf.crf_bwd(torch.zeros(3, 4, crf.MAX_S + 1, device=dev), *idx,
                    lat[:3].contiguous(), valid, last)


def _gru_inputs(T, B, D, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (rng.normal(size=(3 * H, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.5 * rng.normal(size=3 * H)).astype(np.float32)
    sW = (rng.normal(size=(3 * H, H)) / np.sqrt(H)).astype(np.float32)
    dh = rng.normal(size=(T, B, H)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, iW, b, sW, dh)]


GRU_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (5, 3, 300, 40),
              (300, 64, 96, 96), (200, 128, 256, 256), (120, 37, 384, 384)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_gru_kernels_match_twins(dev, shape, reverse):
    x, iW, b, sW, dh = (a.to(dev) for a in _gru_inputs(*shape))
    want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse)
    nf, nb = gru.gru_fwd.launches, gru.gru_bwd_recompute.launches
    got = gru.gru_fwd(x, iW, b, sW, reverse=reverse)
    bw = gru.gru_bwd_recompute_plain(dh, want, x, sW, iW, b, reverse=reverse)
    bk = gru.gru_bwd_recompute(dh, want, x, sW, iW, b, reverse=reverse)
    torch.cuda.synchronize()
    assert (gru.gru_fwd.launches, gru.gru_bwd_recompute.launches) == \
        (nf + 1, nb + 1)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4
    assert bk[0].shape == bw[0].shape
    assert _rel_err(bk[0], bw[0]) < 1e-4
    for g, w in zip(bk[1:], bw[1:]):
        assert g.shape[1:] == w.shape[1:]
        assert _rel_err(g.sum(0), w.sum(0)) < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,width", [("lstm", 256), ("gru", 96)])
def test_remap_shapes_match_twins(dev, cell, width, reverse):
    """The forwards (rows 1 and 7) at the remap path's shapes
    (prepare_mapped_reads: batches of 8 whole reads, here 8192 blocks,
    a read of 32768 samples at stride 4): the mLstm 256 model's width and
    the shipped remap model's, against their twins at the layers'
    tolerance, on the plan's instance."""
    T, B = 8192, 8
    if cell == "lstm":
        args = [a.to(dev) for a in _lstm_inputs(T, B, width, width)]
        op, plain = lstm.lstm_fwd, lstm.lstm_fwd_plain
    else:
        args = [a.to(dev) for a in _gru_inputs(T, B, width, width)[:4]]
        op, plain = gru.gru_fwd, gru.gru_fwd_plain
    want = plain(*args, reverse=reverse)
    n = op.launches
    got = op(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert op.launches == n + 1
    assert got.shape == want.shape == (T, B, width)
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_pre_and_c_kernels_match_twin(dev, shape, reverse):
    """The forward's emit="pre" and emit="c" modes (kernel 1)."""
    args = [a.to(dev) for a in _lstm_inputs(*shape)]
    for emit in ("pre", "c"):
        want = lstm.lstm_fwd_plain(*args, reverse=reverse, emit=emit)
        n = lstm.lstm_fwd.launches
        got = lstm.lstm_fwd(*args, reverse=reverse, emit=emit)
        torch.cuda.synchronize()
        assert lstm.lstm_fwd.launches == n + 1
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert (g - w).abs().max().item() < 1e-4


def _check_partials(got, want):
    assert got[0].shape == want[0].shape
    assert _rel_err(got[0], want[0]) < 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert g.shape[1:] == w.shape[1:]
        assert _rel_err(g.sum(0), w.sum(0)) < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_fusedw_and_recompute_kernels_match_twins(dev, shape, reverse):
    """Kernel 11 (from stored pre) and kernel 12 (rebuilding pre)."""
    T, B, D, H = shape
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(*shape))
    h, c, pre = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                    emit="pre")
    dh = torch.from_numpy(np.random.default_rng(4).normal(
        size=(T, B, H)).astype(np.float32)).to(dev)
    c_prev = lstm.prev_state(c, reverse)
    nf, nr = lstm.lstm_bwd_fusedw.launches, lstm.lstm_bwd_recompute.launches
    got = lstm.lstm_bwd_fusedw(dh, pre, c, c_prev, h, x, sW, iW,
                               reverse=reverse)
    want = lstm.lstm_bwd_fusedw_plain(dh, pre, c, c_prev, h, x, sW, iW,
                                      reverse=reverse)
    _check_partials(got, want)
    got = lstm.lstm_bwd_recompute(dh, c, h, x, sW, iW, b, reverse=reverse)
    want = lstm.lstm_bwd_recompute_plain(dh, c, h, x, sW, iW, b,
                                         reverse=reverse)
    torch.cuda.synchronize()
    _check_partials(got, want)
    assert (lstm.lstm_bwd_fusedw.launches,
            lstm.lstm_bwd_recompute.launches) == (nf + 1, nr + 1)


def test_lstm_backwards_reject_bad_input(dev):
    T, B, D, H = 6, 3, 5, 8
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(T, B, D, H))
    h, c, pre = lstm.lstm_fwd_plain(x, iW, b, sW, emit="pre")
    dh = torch.ones_like(h)
    with pytest.raises(ValueError, match="pre"):
        lstm.lstm_bwd_fusedw(dh, pre[:, :, :-1].contiguous(), c, c, h, x,
                             sW, iW)
    with pytest.raises(ValueError, match="float32"):
        lstm.lstm_bwd_recompute(dh, c.double(), h, x, sW, iW, b)
    with pytest.raises(ValueError, match="contiguous"):
        lstm.lstm_bwd_recompute(dh, c, h, x, sW, iW.t().contiguous().t(), b)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_gru_residual_kernels_match_twins(dev, shape, reverse):
    """The forward with emit_residuals (kernel 7) and kernel 13; kernel 13
    leaves the gate streams it reads as they were."""
    x, iW, b, sW, dh = (a.to(dev) for a in _gru_inputs(*shape))
    want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                             emit_residuals=True)
    nf, nb = gru.gru_fwd.launches, gru.gru_bwd_fusedw.launches
    got = gru.gru_fwd(x, iW, b, sW, reverse=reverse, emit_residuals=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() < 1e-4
    h, gh, gx = want
    h_prev = lstm.prev_state(h, reverse)
    kept = (gx.clone(), gh.clone())
    bk = gru.gru_bwd_fusedw(dh, gx, gh, h_prev, x, sW, iW, reverse=reverse)
    bw = gru.gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW,
                                  reverse=reverse)
    torch.cuda.synchronize()
    assert (gru.gru_fwd.launches, gru.gru_bwd_fusedw.launches) == \
        (nf + 1, nb + 1)
    assert torch.equal(gx, kept[0]) and torch.equal(gh, kept[1])
    _check_partials(bk, bw)


def test_gru_fusedw_rejects_bad_input(dev):
    x, iW, b, sW, dh = (a.to(dev) for a in _gru_inputs(6, 3, 5, 8))
    h, gh, gx = gru.gru_fwd_plain(x, iW, b, sW, emit_residuals=True)
    with pytest.raises(ValueError, match="gh"):
        gru.gru_bwd_fusedw(dh, gx, gh[:-1].contiguous(), h, x, sW, iW)
    with pytest.raises(ValueError, match="contiguous"):
        gru.gru_bwd_fusedw(dh, gx.transpose(0, 1).contiguous()
                           .transpose(0, 1), gh, h, x, sW, iW)


POLICY_ENVS = [("lstm", {}), ("lstm", {"TAIYAKI_TPU_ACTS_BWD": "0"}),
               ("lstm", {"TAIYAKI_TPU_RECOMPUTE": "1"}), ("gru", {}),
               ("gru", {"TAIYAKI_TPU_NO_RECOMPUTE": "1"})]
POLICY_KERNEL = {"lstm": ("lstm_bwd_acts", "lstm_bwd_fusedw",
                          "lstm_bwd_recompute"),
                 "gru": ("gru_bwd_recompute", "gru_bwd_fusedw")}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,env", POLICY_ENVS)
def test_layer_policy_on_card(dev, cell, env, reverse, monkeypatch):
    """Each policy's layer on the card launches its backward kernel and
    no other, gives the CPU twins' gradients (1e-4 relative), and a
    retained graph gives the same gradients twice."""
    for name in ("TAIYAKI_TPU_ACTS_BWD", "TAIYAKI_TPU_RECOMPUTE",
                 "TAIYAKI_TPU_NO_RECOMPUTE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mod, layer = ((lstm, rnn.lstm_layer) if cell == "lstm"
                  else (gru, rnn.gru_layer))
    make = _lstm_inputs if cell == "lstm" else _gru_inputs
    x, iW, b, sW = make(41, 11, 9, 24)[:4]
    dh = torch.from_numpy(np.random.default_rng(5).normal(
        size=(41, 11, 24)).astype(np.float32))
    grads = {}
    for device in ("cpu", dev):
        leaves = [a.to(device).requires_grad_() for a in (x, iW, b, sW)]
        before = {k: getattr(mod, k).launches for k in POLICY_KERNEL[cell]}
        h = layer(*leaves, reverse=reverse)
        first = torch.autograd.grad(h, leaves, dh.to(device),
                                    retain_graph=True)
        second = torch.autograd.grad(h, leaves, dh.to(device))
        torch.cuda.synchronize()
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)
        grads[device if device == "cpu" else "cuda"] = first
        ran = {k for k in POLICY_KERNEL[cell]
               if getattr(mod, k).launches != before[k]}
        assert ran == (set() if device == "cpu" else {_policy_kernel(cell)})
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(g.cpu(), w) < 1e-4


def _policy_kernel(cell):
    """The backward kernel the current switches choose for `cell`."""
    if cell == "lstm":
        return {"acts": "lstm_bwd_acts", "pre": "lstm_bwd_fusedw",
                "recompute": "lstm_bwd_recompute"}[rnn.lstm_policy()]
    return {"recompute": "gru_bwd_recompute",
            "stored": "gru_bwd_fusedw"}[rnn.gru_policy()]


# (T, B, L, mod columns, posterior atol): every block shape of kernels
# 9-10 (L up to 256, 512, 1024, 2048, 4096, 8192 and 16384), the training
# shape, and lattices past the fused kernels' 8192 positions with T >= L,
# so that rows have a path.
STREAM_SHAPES = [(37, 5, 12, 0, 1e-5), (41, 9, 300, 3, 1e-5),
                 (60, 4, 900, 0, 1e-5), (800, 256, 512, 0, 1e-5),
                 (2000, 3, 1900, 2, 3e-4), (4000, 3, 3712, 0, 3e-4),
                 (7000, 3, 8192, 0, 3e-4), (10000, 3, 9000, 3, 3e-4)]


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_crf_stream_kernels_match_twins(dev, shape):
    from taiyaki_tpu_torch.ops import flipflop
    T, B, L, nmod, p_tol = shape
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        T, B, L, nmod=nmod, dev=dev)
    mod = (mmidx, mfact) if nmod else (None, None)
    stay_all, move_all = flipflop._select_streams(lp, sidx, midx, *mod)
    f0, s0, lat0 = crf.crf_fwd_streams_plain(stay_all, move_all, valid)
    p0 = crf.crf_bwd_posteriors_plain(stay_all, move_all, lat0, valid, last)
    nf, nb = crf.crf_fwd_streams.launches, crf.crf_bwd_posteriors.launches
    f1, s1, lat1 = crf.crf_fwd_streams(stay_all, move_all, valid)
    p1 = crf.crf_bwd_posteriors(stay_all, move_all, lat1, valid, last)
    p2 = crf.crf_bwd_posteriors(stay_all, move_all, lat1, valid, last)
    _, s3, none = crf.crf_fwd_streams(stay_all, move_all, valid,
                                      emit_lattice=False)
    torch.cuda.synchronize()
    assert (crf.crf_fwd_streams.launches,
            crf.crf_bwd_posteriors.launches) == (nf + 2, nb + 2)
    assert none is None and torch.equal(s1, s3)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4)
    assert _lattice_close(f1, f0, 1e-4)
    for got, want, again in zip(p1, p0, p2):
        assert torch.isfinite(got).all() and (got[:, 1] == 0).all()
        torch.testing.assert_close(got, want, rtol=0, atol=p_tol)
        assert torch.equal(got, again)
    assert p1[0].sum().item() > 0
    # the gradient the route scatters from them, against kernels 5-6's
    # (whose lattice limit is 8192)
    if L <= crf.MAX_L:
        g = [flipflop._scatter_posteriors(lp.shape, p1[0], p1[1].clone(),
                                          sidx, midx, *mod) for _ in "ab"]
        _, _, flat = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
        want = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, flat, valid, last)
        torch.testing.assert_close(g[0], want, rtol=0, atol=p_tol)
        torch.testing.assert_close(g[0], g[1], rtol=0, atol=1e-6)


def test_crf_stream_kernels_reject_bad_input(dev):
    """Bad tensors raise; a lattice past MAX_L_STREAMS no longer does (the
    device-memory instance takes it)."""
    stay = torch.zeros(3, 2, crf.MAX_L_STREAMS + 1, device=dev)
    valid = torch.ones(2, crf.MAX_L_STREAMS + 1, dtype=torch.int32,
                       device=dev)
    _, score, _ = crf.crf_fwd_streams(stay, stay, valid)
    torch.cuda.synchronize()
    assert torch.isfinite(score).all()
    stay, valid = stay[:, :, :8].contiguous(), valid[:, :8].contiguous()
    with pytest.raises(ValueError, match="float32"):
        crf.crf_fwd_streams(stay.double(), stay, valid)
    with pytest.raises(ValueError, match="lattice"):
        crf.crf_bwd_posteriors(stay, stay, stay[:2].contiguous(), valid,
                               torch.zeros(2, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("env", ["TAIYAKI_TPU_NO_SCORE_FUSE",
                                 "TAIYAKI_TPU_F32_SCORES", None])
def test_cat_mod_loss_routes_on_card(dev, env, monkeypatch):
    """The cat_mod loss on the card under each switch (or past the fused
    width, with MAX_L lowered) launches kernels 9-10 (the forward and the
    d lp entry, crf_grad_streams) and not 5-6, and gives the CPU twins'
    value (1e-5 relative) and gradient (1e-5)."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    for name in ("TAIYAKI_TPU_NO_SCORE_FUSE", "TAIYAKI_TPU_F32_SCORES"):
        monkeypatch.delenv(name, raising=False)
    if env is None:
        monkeypatch.setattr(crf, "MAX_L", 8)
    else:
        monkeypatch.setenv(env, "1")
    rng = np.random.default_rng(7)
    T, B, L = 60, 6, 30
    offsets = np.array([0, 2, 3, 5, 6], np.int32)
    x = rng.normal(size=(T, B, 40 + 6)).astype(np.float32)
    seqlens = rng.integers(2, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    cats = np.zeros((B, L), np.int32)
    for i in range(B):
        bases = rng.integers(0, 4, size=seqlens[i])
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(bases)
        cats[i, :seqlens[i]] = np.where(np.isin(bases, [0, 2]),
                                        rng.integers(0, 2, seqlens[i]), 0)
    weights = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        tx = torch.from_numpy(x).to(device).requires_grad_()
        before = [k.launches for k in (crf.crf_fwd, crf.crf_bwd,
                                       crf.crf_fwd_streams,
                                       crf.crf_grad_streams)]
        loss = flipflop.cat_mod_flipflop_loss(
            tx, *(torch.from_numpy(a).to(device)
                  for a in (seqs, seqlens, cats)), offsets, weights, 2.0)
        loss.sum().backward()
        after = [k.launches for k in (crf.crf_fwd, crf.crf_bwd,
                                      crf.crf_fwd_streams,
                                      crf.crf_grad_streams)]
        ran = [a - b for a, b in zip(after, before)]
        assert ran == ([0, 0, 0, 0] if device == "cpu" else [0, 0, 1, 1])
        out[str(device)] = (loss.detach().cpu(), tx.grad.cpu())
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gg, gc, rtol=0, atol=1e-5)


def test_crf_stream_kernels_past_16384_match_twins(dev):
    """Kernels 9-10 at L=20000 (T=20100, B=1), past 16384 positions: their
    chains in a cluster of 8 CTAs a row, against the twins, at the long
    lattices' tolerances (posteriors 3e-4)."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    T, L = 20100, 20000
    rng = np.random.default_rng(11)
    lp = torch.from_numpy(rng.normal(size=(T, 1, 40)).astype(np.float32))
    seqs = np.zeros((1, L), np.int32)
    seqs[0] = flipflopfings.flipflop_code(rng.integers(0, 4, size=L))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    sidx, midx, _, _, valid, last = (t.to(dev) for t in
                                     flipflop._lattice_inputs(
                                         stay, move,
                                         torch.tensor([L], dtype=torch.int32),
                                         40, None, None))
    stay_all, move_all = flipflop._select_streams(lp.to(dev), sidx, midx,
                                                  None, None)
    f0, s0, lat0 = crf.crf_fwd_streams_plain(stay_all, move_all, valid)
    p0 = crf.crf_bwd_posteriors_plain(stay_all, move_all, lat0, valid, last)
    f1, s1, lat1 = crf.crf_fwd_streams(stay_all, move_all, valid)
    p1 = crf.crf_bwd_posteriors(stay_all, move_all, lat1, valid, last)
    torch.cuda.synchronize()
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4)
    assert _lattice_close(f1, f0, 1e-4)
    for got, want in zip(p1, p0):
        torch.testing.assert_close(got, want, rtol=0, atol=3e-4)
    mass = p1[0].sum().item() + p1[1].sum().item()
    assert abs(mass - T) <= 1e-3 * T


# Kernel 10's redesign (the backward chain, then the posterior pass with
# the `post` and `grad` epilogues) and kernel 9's, at every band edge of
# csrc/crf.cu's TT_STREAM_BANDS and one past it: (L, T, B, seqlen of row
# 0).  Up to 8193 positions row 0 fills the lattice with T = L + 8 (a
# path), past that T = 8008 and row 0 holds 8000 positions, whose live
# states still cross the CTAs of the cluster; 32769 takes the device-memory
# instance.  Odd L copies 4 bytes at a time.
STREAM_EDGES = [(64, 72, 5, 64), (65, 73, 5, 65), (1024, 1032, 4, 1024),
                (1025, 1033, 4, 1025), (2048, 2056, 3, 2048),
                (2049, 2057, 3, 2049), (4096, 4104, 2, 4096),
                (4097, 4105, 2, 4097), (8192, 8200, 1, 8192),
                (8193, 8201, 1, 8193), (16384, 8008, 1, 8000),
                (16385, 8008, 1, 8000), (32768, 8008, 1, 8000),
                (32769, 8008, 1, 8000), (600, 1, 4, 1)]


def _stream_case(T, B, L, n0, dev, seed=5, nmod=2):
    """Cat_mod streams of T x B rows of L positions (row 0 of n0
    positions, the others shorter, one with none) with the route's index
    vectors: (stay_all, move_all, valid, last, sidx, midx, mmidx, mfact,
    S)."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    rng = np.random.default_rng(seed)
    S = 40 + 1 + nmod
    seqlens = rng.integers(1, min(n0, T + 1) + 1, size=B).astype(np.int32)
    seqlens[0] = n0
    if B > 1:
        seqlens[1] = 0
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1))
                          .astype(np.int32))
    mf = torch.from_numpy(rng.uniform(0.5, 2.0, size=(B, L - 1))
                          .astype(np.float32))
    sidx, midx, mmidx, mfact, valid, last = (
        t.to(dev) for t in flipflop._lattice_inputs(
            stay, move, torch.from_numpy(seqlens), S, mm, mf))
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    stay_all, move_all = flipflop._select_streams(lp.to(dev), sidx, midx,
                                                  mmidx, mfact)
    return stay_all, move_all, valid, last, sidx, midx, mmidx, mfact, S


def _check_streams(case, atol):
    """Kernel 9, and kernel 10's entries twice each (bitwise the same),
    against their twins: lattices 1e-4, posteriors atol, d lp atol times
    its twin's largest entry."""
    stay_all, move_all, valid, last, sidx, midx, mmidx, mfact, S = case
    idx = (sidx, midx, mmidx, mfact)
    f0, s0, lat0 = crf.crf_fwd_streams_plain(stay_all, move_all, valid)
    p0 = crf.crf_bwd_posteriors_plain(stay_all, move_all, lat0, valid, last)
    g0 = crf.scatter_posteriors(stay_all.shape[:2] + (S,), p0[0],
                                p0[1].clone(), *idx)
    n = [k.launches for k in (crf.crf_fwd_streams, crf.crf_bwd_posteriors,
                              crf.crf_grad_streams)]
    f1, s1, lat1 = crf.crf_fwd_streams(stay_all, move_all, valid)
    p1 = crf.crf_bwd_posteriors(stay_all, move_all, lat1, valid, last)
    p2 = crf.crf_bwd_posteriors(stay_all, move_all, lat1, valid, last)
    g1 = crf.crf_grad_streams(stay_all, move_all, lat1, valid, last, *idx, S)
    g2 = crf.crf_grad_streams(stay_all, move_all, lat1, valid, last, *idx, S)
    torch.cuda.synchronize()
    assert [k.launches for k in (crf.crf_fwd_streams, crf.crf_bwd_posteriors,
                                 crf.crf_grad_streams)] == [
        n[0] + 1, n[1] + 2, n[2] + 2]
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4)
    assert _lattice_close(f1, f0, 1e-4)
    for got, want, again in zip(p1, p0, p2):
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        assert torch.equal(got, again)
    assert g1.shape == g0.shape
    torch.testing.assert_close(g1, g0, rtol=0,
                               atol=atol * max(1.0, g0.abs().max().item()))
    assert torch.equal(g1, g2)
    return p1


@pytest.mark.parametrize("edge", STREAM_EDGES)
def test_crf_streams_at_band_edges(dev, edge):
    """Kernels 9-10 at each band edge and one past it (and T = 1): the
    card's layout is the Python mirror's, and the kernels match their
    twins, bitwise from run to run; a row with a path has posteriors
    summing to 1 a step."""
    L, T, B, n0 = edge
    lib = crf.cuda_lib.load("crf", crf._SIGNATURES)
    packed = lib.tt_crf_streams_layout(L)
    mirror = crf.streams_layout(L)
    assert (packed >> 16, (packed >> 8) & 0xff, packed & 0xff) == (
        mirror if mirror else (0, 0, 0))
    atol = 1e-5 if T <= 2100 else 3e-4
    p1 = _check_streams(_stream_case(T, B, L, n0, dev), atol)
    if n0 <= T + 1:
        mass = (p1[0][:, 0].sum() + p1[1][:, 0].sum()).item()
        assert abs(mass - T) <= 1e-3 * T


def test_crf_streams_offset_and_unaligned(dev):
    """Every input of kernels 9-10 a contiguous view at an odd float
    offset, at L = 509 (not a multiple of 4), gives the aligned call's
    results bitwise (the same arithmetic, 4-byte copies)."""
    case = _stream_case(300, 6, 509, 280, dev)
    stay_all, move_all, valid, last, sidx, midx, mmidx, mfact, S = case
    _check_streams(case, 1e-5)
    idx = (sidx, midx, mmidx, mfact)
    off = _offset_all([stay_all, move_all, valid])
    f0, s0, lat0 = crf.crf_fwd_streams(stay_all, move_all, valid)
    f1, s1, lat1 = crf.crf_fwd_streams(*off)
    assert torch.equal(s1, s0) and torch.equal(lat1, lat0)
    sargs = [stay_all, move_all, lat0, valid, last]
    for a, b in zip(crf.crf_bwd_posteriors(*_offset_all(sargs)),
                    crf.crf_bwd_posteriors(*sargs)):
        assert torch.equal(a, b)
    assert torch.equal(
        crf.crf_grad_streams(*_offset_all(sargs + list(idx)), S),
        crf.crf_grad_streams(*sargs, *idx, S))


def test_crf_grad_streams_wide_columns(dev):
    """The d lp entry at S = 150 > 128 columns (the streams route's alone:
    kernel 6's columns are 8-bit) against its twin."""
    _check_streams(_stream_case(200, 5, 120, 120, dev, nmod=109), 1e-5)


def test_crf_grad_streams_rejects_bad_input(dev):
    case = _stream_case(20, 3, 16, 10, dev)
    stay_all, move_all, valid, last, sidx, midx, mmidx, mfact, S = case
    lat = torch.zeros_like(stay_all)
    with pytest.raises(ValueError, match="mfact"):
        crf.crf_grad_streams(stay_all, move_all, lat, valid, last, sidx,
                             midx, mmidx, mfact.double(), S)
    with pytest.raises(ValueError, match="sidx"):
        crf.crf_grad_streams(stay_all, move_all, lat, valid, last,
                             sidx[:, :8].contiguous(), midx, mmidx, mfact, S)


def _scan_case(cell, shape, reverse, dev):
    """gates_x = x . iW^T + b of a layer's inputs, sW, iW and dh."""
    T, B, D, H = shape
    make = _lstm_inputs if cell == "lstm" else _gru_inputs
    x, iW, b, sW = (a.to(dev) for a in make(*shape)[:4])
    dh = torch.from_numpy(np.random.default_rng(6).normal(
        size=(T, B, H)).astype(np.float32)).to(dev)
    return torch.matmul(x, iW.t()) + b, sW, iW, dh


@pytest.mark.parametrize("with_iw", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_scan_kernels_match_twins(dev, shape, reverse, with_iw):
    """Kernels 14 (h; h, c, pre) and 15 (dpre; dpre, d_x) against their
    twins; kernel 14 leaves gates_x as it was."""
    gx, sW, iW, dh = _scan_case("lstm", shape, reverse, dev)
    kept = gx.clone()
    n = lstm.lstm_scan_fwd.launches, lstm.lstm_scan_bwd.launches
    want = lstm.lstm_scan_fwd_plain(gx, sW, reverse=reverse, residuals=True)
    got = lstm.lstm_scan_fwd(gx, sW, reverse=reverse, residuals=True)
    h = lstm.lstm_scan_fwd(gx, sW, reverse=reverse)
    torch.cuda.synchronize()
    assert torch.equal(gx, kept)
    for g, w in zip(got + (h,), want + (want[0],)):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() < 1e-4
    _, c, pre = want
    iw = iW if with_iw else None
    args = (dh, pre, c, lstm.prev_state(c, reverse), sW)
    bk = lstm.lstm_scan_bwd(*args, reverse=reverse, iW=iw)
    bw = lstm.lstm_scan_bwd_plain(*args, reverse=reverse, iW=iw)
    torch.cuda.synchronize()
    assert (lstm.lstm_scan_fwd.launches, lstm.lstm_scan_bwd.launches) == \
        (n[0] + 2, n[1] + 1)
    bk, bw = (bk, bw) if with_iw else ((bk,), (bw,))
    for g, w in zip(bk, bw):
        assert g.shape == w.shape
        assert _rel_err(g, w) < 1e-4


@pytest.mark.parametrize("with_iw", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_gru_scan_kernels_match_twins(dev, shape, reverse, with_iw):
    """Kernels 16 (h; h, gh) and 17 (dgx, dgh; and d_x) against their
    twins; neither writes the gate streams it reads."""
    gx, sW, iW, dh = _scan_case("gru", shape, reverse, dev)
    n = gru.gru_scan_fwd.launches, gru.gru_scan_bwd.launches
    want = gru.gru_scan_fwd_plain(gx, sW, reverse=reverse, residuals=True)
    got = gru.gru_scan_fwd(gx, sW, reverse=reverse, residuals=True)
    h = gru.gru_scan_fwd(gx, sW, reverse=reverse)
    torch.cuda.synchronize()
    for g, w in zip(got + (h,), want + (want[0],)):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() < 1e-4
    h0, gh = want
    kept = gx.clone(), gh.clone()
    iw = iW if with_iw else None
    args = (dh, gx, gh, lstm.prev_state(h0, reverse), sW)
    bk = gru.gru_scan_bwd(*args, reverse=reverse, iW=iw)
    bw = gru.gru_scan_bwd_plain(*args, reverse=reverse, iW=iw)
    torch.cuda.synchronize()
    assert torch.equal(gx, kept[0]) and torch.equal(gh, kept[1])
    assert (gru.gru_scan_fwd.launches, gru.gru_scan_bwd.launches) == \
        (n[0] + 2, n[1] + 1)
    assert len(bk) == len(bw) == (3 if with_iw else 2)
    for g, w in zip(bk, bw):
        assert g.shape == w.shape
        assert _rel_err(g, w) < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_of_input_gates_matches_layer_on_card(dev, cell, reverse):
    """scan(x . iW^T + b, sW) on kernels 14-17 against the layer on x on
    kernels 1, 4 (7, 8 for the GRU): h within 1e-4, d_x, d_iW, d_b and
    d_sW within 1e-4 relative."""
    layer, scan = ((rnn.lstm_layer, rnn.lstm_scan) if cell == "lstm"
                   else (rnn.gru_layer, rnn.gru_scan))
    make = _lstm_inputs if cell == "lstm" else _gru_inputs
    args = [a.to(dev) for a in make(150, 19, 40, 48)[:4]]
    dh = torch.from_numpy(np.random.default_rng(8).normal(
        size=(150, 19, 48)).astype(np.float32)).to(dev)
    out = []
    for how in ("scan", "layer"):
        leaves = [a.clone().requires_grad_() for a in args]
        x, iW, b, sW = leaves
        h = (scan(torch.matmul(x, iW.t()) + b, sW, reverse=reverse)
             if how == "scan" else layer(x, iW, b, sW, reverse=reverse))
        out.append([h.detach()] + list(torch.autograd.grad(h, leaves, dh)))
    torch.cuda.synchronize()
    assert (out[0][0] - out[1][0]).abs().max().item() < 1e-4
    for g, w in zip(out[0][1:], out[1][1:]):
        assert _rel_err(g, w) < 1e-4


def test_scan_kernels_reject_bad_input(dev):
    gx, sW, iW, dh = _scan_case("lstm", (6, 3, 5, 8), False, dev)
    with pytest.raises(ValueError, match="gates_x"):
        lstm.lstm_scan_fwd(gx[:, :, :-1].contiguous(), sW)
    h, c, pre = lstm.lstm_scan_fwd_plain(gx, sW, residuals=True)
    with pytest.raises(ValueError, match="iW"):
        lstm.lstm_scan_bwd(dh, pre, c, c, sW, iW=iW[:-1].contiguous())
    gx, sW, iW, dh = _scan_case("gru", (6, 3, 5, 8), False, dev)
    h, gh = gru.gru_scan_fwd_plain(gx, sW, residuals=True)
    with pytest.raises(ValueError, match="float32"):
        gru.gru_scan_bwd(dh, gx, gh.double(), h, sW)


# The forward recurrences' cluster instance (ops/rnn_plan.py, csrc/
# rec_cluster.cuh), which every shape above already takes by default: here
# also H=96 (the shipped remap model), an odd H, B=1, T=1, batches that
# are not a multiple of the plan's tile and the trainer defaults' largest
# sub-batch (H=384, 341 rows: three waves of clusters of 16), every emit
# mode and RES, against the twins and against the forced L2 instance.  The cluster instance sums
# over k in KS slices, the L2 one in one chain: both within 1e-4 of each
# other, as of the twins (on the card, at most 1e-5 apart, the largest on
# the LSTM's pre).
CLUSTER_LSTM_SHAPES = LSTM_SHAPES + [(24, 341, 384, 384)] + [
    (60, 128, 96, 96), (40, 21, 100, 100), (30, 1, 64, 256), (1, 9, 32, 256),
    (50, 13, 256, 256)]
CLUSTER_GRU_SHAPES = GRU_SHAPES + [(40, 21, 100, 100), (30, 1, 64, 256),
                                   (1, 9, 32, 96), (50, 13, 256, 256)]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _counts(fn):
    return {k: c.launches for k, c in fn.by_instance.items()}


def _plan(gates, H, B):
    """The plan the wrappers take on this card."""
    mod = lstm if gates == 4 else gru
    return rnn_plan.rec_plan(gates, H, B, mod.clusters_per_wave(
        torch.cuda.current_device()))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", CLUSTER_LSTM_SHAPES)
def test_lstm_cluster_instance_matches_twin_and_l2(dev, shape, reverse):
    T, B, D, H = shape
    assert _plan(4, H, B).instance == "cluster"
    args = [a.to(dev) for a in _lstm_inputs(*shape)]
    for emit in lstm.EMITS:
        want = _as_tuple(lstm.lstm_fwd_plain(*args, reverse=reverse,
                                             emit=emit))
        n = _counts(lstm.lstm_fwd)
        got = _as_tuple(lstm.lstm_fwd(*args, reverse=reverse, emit=emit))
        l2 = _as_tuple(lstm.lstm_fwd(*args, reverse=reverse, emit=emit,
                                     instance="l2"))
        torch.cuda.synchronize()
        assert _counts(lstm.lstm_fwd) == {"cluster": n["cluster"] + 1,
                                          "l2": n["l2"] + 1}
        assert len(got) == len(want) == len(l2)
        for g, w, l in zip(got, want, l2):
            assert g.shape == w.shape
            assert (g - w).abs().max().item() < 1e-4
            assert (g - l).abs().max().item() < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", CLUSTER_GRU_SHAPES)
def test_gru_cluster_instance_matches_twin_and_l2(dev, shape, reverse):
    T, B, D, H = shape
    assert _plan(3, H, B).instance == "cluster"
    x, iW, b, sW = (a.to(dev) for a in _gru_inputs(*shape)[:4])
    for res in (False, True):
        want = _as_tuple(gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                                           emit_residuals=res))
        n = _counts(gru.gru_fwd)
        got = _as_tuple(gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                                    emit_residuals=res))
        l2 = _as_tuple(gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                                   emit_residuals=res, instance="l2"))
        torch.cuda.synchronize()
        assert _counts(gru.gru_fwd) == {"cluster": n["cluster"] + 1,
                                        "l2": n["l2"] + 1}
        for g, w, l in zip(got, want, l2):
            assert g.shape == w.shape
            assert (g - w).abs().max().item() < 1e-4
            assert (g - l).abs().max().item() < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,shape", [
    ("lstm", s) for s in CLUSTER_LSTM_SHAPES[-5:] + [(200, 128, 256, 256)]]
    + [("gru", s) for s in CLUSTER_GRU_SHAPES[-4:] + [(300, 64, 96, 96)]])
def test_scan_forwards_on_cluster_plan(dev, cell, shape, reverse):
    """Kernels 14 and 16 on the same plan as the layers: h and residuals
    against the twins and the forced L2 instance; kernel 14's cluster run
    leaves the caller's gates_x as it was."""
    gx, sW, _, _ = _scan_case(cell, shape, reverse, dev)
    kept = gx.clone()
    mod = lstm if cell == "lstm" else gru
    fwd = getattr(mod, cell + "_scan_fwd")
    plain = getattr(mod, cell + "_scan_fwd_plain")
    assert _plan(4 if cell == "lstm" else 3, shape[3],
                 shape[1]).instance == "cluster"
    for residuals in (False, True):
        want = _as_tuple(plain(gx, sW, reverse=reverse, residuals=residuals))
        n = _counts(fwd)
        got = _as_tuple(fwd(gx, sW, reverse=reverse, residuals=residuals))
        l2 = _as_tuple(fwd(gx, sW, reverse=reverse, residuals=residuals,
                           instance="l2"))
        torch.cuda.synchronize()
        assert torch.equal(gx, kept)
        assert _counts(fwd) == {"cluster": n["cluster"] + 1,
                                "l2": n["l2"] + 1}
        for g, w, l in zip(got, want, l2):
            assert g.shape == w.shape
            assert (g - w).abs().max().item() < 1e-4
            assert (g - l).abs().max().item() < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
def test_l2_instance_held_at_512(dev, reverse):
    """H=512 fits no cluster plan: the plan takes the L2 instance, which
    stays as it was, for both layers and both scans."""
    shape = (20, 9, 64, 512)
    assert _plan(4, 512, 9).instance == "l2"
    assert _plan(3, 512, 9).instance == "l2"
    args = [a.to(dev) for a in _lstm_inputs(*shape)]
    for emit in lstm.EMITS:
        n = _counts(lstm.lstm_fwd)
        got = _as_tuple(lstm.lstm_fwd(*args, reverse=reverse, emit=emit))
        want = _as_tuple(lstm.lstm_fwd_plain(*args, reverse=reverse,
                                             emit=emit))
        torch.cuda.synchronize()
        assert _counts(lstm.lstm_fwd) == dict(n, l2=n["l2"] + 1)
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() < 1e-4
    x, iW, b, sW = (a.to(dev) for a in _gru_inputs(*shape)[:4])
    for res in (False, True):
        n = _counts(gru.gru_fwd)
        got = _as_tuple(gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                                    emit_residuals=res))
        want = _as_tuple(gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                                           emit_residuals=res))
        torch.cuda.synchronize()
        assert _counts(gru.gru_fwd) == dict(n, l2=n["l2"] + 1)
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() < 1e-4
    for cell, mod in (("lstm", lstm), ("gru", gru)):
        gx, sW, _, _ = _scan_case(cell, shape, reverse, dev)
        fwd = getattr(mod, cell + "_scan_fwd")
        n = _counts(fwd)
        got = _as_tuple(fwd(gx, sW, reverse=reverse, residuals=True))
        want = _as_tuple(getattr(mod, cell + "_scan_fwd_plain")(
            gx, sW, reverse=reverse, residuals=True))
        torch.cuda.synchronize()
        assert _counts(fwd) == dict(n, l2=n["l2"] + 1)
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() < 1e-4


@pytest.mark.parametrize("gates,H,B", [(4, 256, 128), (4, 256, 256),
                                       (4, 384, 341), (3, 96, 128),
                                       (3, 256, 256)])
def test_cluster_plans_fit_on_the_card(dev, gates, H, B):
    """The plans of the repo's shapes run as many clusters at once as the
    card's count for their cluster size (read at the smallest plan), the
    count the plan was made with; no size is counted past the card's SMs."""
    mod = lstm if gates == 4 else gru
    per_wave = mod.clusters_per_wave(torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert all(0 < n and n * C <= sms
               for n, C in zip(per_wave, rnn_plan.CLUSTER_SIZES))
    plan = _plan(gates, H, B)
    assert plan.instance == "cluster"
    assert mod.cluster_occupancy(H, plan) == \
        per_wave[rnn_plan.CLUSTER_SIZES.index(plan.C)]


def test_cluster_kernel_refuses_a_bad_plan(dev, monkeypatch):
    """The C side checks the plan it is given: a byte count that is not
    the layout's, rows a lane it has no instance for (3, 11) or a tile
    past 32 rows returns cudaErrorInvalidValue and the wrapper raises; the
    same plan with 2 rows a lane runs."""
    args = [a.to(dev) for a in _lstm_inputs(5, 8, 16, 32)]
    good = _plan(4, 32, 8)
    assert good.instance == "cluster"
    odd = rnn_plan.Plan("cluster", 1, 6, 3, 1, rnn_plan.cluster_smem(32, 1,
                                                                     6, 1))
    for bad in (good._replace(smem=good.smem + 16), good._replace(RB=11),
                good._replace(BT=33), odd):
        monkeypatch.setattr(rnn_plan, "rec_plan",
                            lambda *a, _p=bad, **k: _p)
        with pytest.raises(RuntimeError, match="invalid argument"):
            lstm.lstm_fwd(*args)
    monkeypatch.setattr(rnn_plan, "rec_plan",
                        lambda *a, **k: odd._replace(RB=2))
    got = lstm.lstm_fwd(*args)
    assert (got - lstm.lstm_fwd_plain(*args)).abs().max().item() < 1e-4


# The backward chains' cluster instance (ops/rnn_plan.py `bwd_plan`,
# kernel 3a of csrc/lstm.cu and csrc/gru.cu), which every backward above
# already takes by default: here each of the seven rows (kernels 4, 11,
# 12, 15; 8, 13, 17) at H of 16, 17, 96, 100, 256 and 384, both
# directions, T=1, B below the plan's tile (H=384, B=5: BT=10) and B not a
# multiple of it, against the twins and the forced L2 instance, d_b
# summed over its per-tile partials (ceil(B / BT) of them).  The cluster
# instance sums each unit's C partials in rank order, the L2 one over all
# gates in one chain: within 1e-4 relative of each other, as of the twins.
BWD_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (1, 9, 32, 96),
              (60, 3, 40, 96), (300, 64, 96, 96), (40, 21, 100, 100),
              (50, 37, 64, 256), (200, 128, 256, 256), (12, 5, 32, 384),
              (30, 128, 96, 384), (24, 341, 384, 384)]


def _bwd_plan(gates, H, B):
    """The backward plan the wrappers take on this card."""
    mod = lstm if gates == 4 else gru
    return rnn_plan.bwd_plan(gates, H, B, mod.clusters_per_wave(
        torch.cuda.current_device()))


def _lstm_bwd_rows(shape, reverse, dev):
    """(wrapper, twin, args, keywords) of kernels 4, 11, 12 and 15 on one
    layer's residuals."""
    T, B, D, H = shape
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(*shape))
    h, c, acts, tc = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                         emit="acts")
    pre = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse, emit="pre")[2]
    dh = torch.from_numpy(np.random.default_rng(9).normal(
        size=(T, B, H)).astype(np.float32)).to(dev)
    c_prev = lstm.prev_state(c, reverse)
    return [(lstm.lstm_bwd_acts, lstm.lstm_bwd_acts_plain,
             (dh, acts, tc, c_prev, h, x, sW, iW), {}),
            (lstm.lstm_bwd_fusedw, lstm.lstm_bwd_fusedw_plain,
             (dh, pre, c, c_prev, h, x, sW, iW), {}),
            (lstm.lstm_bwd_recompute, lstm.lstm_bwd_recompute_plain,
             (dh, c, h, x, sW, iW, b), {}),
            (lstm.lstm_scan_bwd, lstm.lstm_scan_bwd_plain,
             (dh, pre, c, c_prev, sW), {"iW": iW})]


def _gru_bwd_rows(shape, reverse, dev):
    """(wrapper, twin, args, keywords) of kernels 8 (in place over its
    rebuilt gate streams), 13 and 17 on one layer's residuals."""
    x, iW, b, sW, dh = (a.to(dev) for a in _gru_inputs(*shape))
    h, gh, gx = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                                  emit_residuals=True)
    h_prev = lstm.prev_state(h, reverse)
    return [(gru.gru_bwd_recompute, gru.gru_bwd_recompute_plain,
             (dh, h, x, sW, iW, b), {}),
            (gru.gru_bwd_fusedw, gru.gru_bwd_fusedw_plain,
             (dh, gx, gh, h_prev, x, sW, iW), {}),
            (gru.gru_scan_bwd, gru.gru_scan_bwd_plain,
             (dh, gx, gh, h_prev, sW), {"iW": iW})]


def _check_bwd_row(fn, plain, args, kw, reverse, B, plan):
    """The row on the plan's instance against its twin and the forced L2
    instance; its inputs left as they were; one launch of each instance."""
    kept = [a.clone() for a in args]
    want = plain(*args, reverse=reverse, **kw)
    n = _counts(fn)
    got = fn(*args, reverse=reverse, **kw)
    l2 = fn(*args, reverse=reverse, instance="l2", **kw)
    torch.cuda.synchronize()
    assert _counts(fn) == {"cluster": n["cluster"] + 1, "l2": n["l2"] + 1}
    assert all(torch.equal(a, k) for a, k in zip(args, kept))
    if "scan" in fn.__name__:
        for g, w, l in zip(got, want, l2):
            assert g.shape == w.shape
            assert _rel_err(g, w) < 1e-4 and _rel_err(g, l) < 1e-4
    else:
        assert got[3].shape[0] == -(-B // plan.BT)
        assert l2[3].shape[0] == -(-B // 8)
        _check_partials(got, want)
        _check_partials(got, l2)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_lstm_bwd_cluster_instance_matches_twin_and_l2(dev, shape, reverse):
    """Kernels 4, 11, 12 and 15 on the backward's cluster plan."""
    plan = _bwd_plan(4, shape[3], shape[1])
    assert plan.instance == "cluster"
    for row in _lstm_bwd_rows(shape, reverse, dev):
        _check_bwd_row(*row, reverse, shape[1], plan)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_gru_bwd_cluster_instance_matches_twin_and_l2(dev, shape, reverse):
    """Kernels 8, 13 and 17 on the backward's cluster plan; kernel 8 writes
    its gradients over the gate streams it rebuilds."""
    plan = _bwd_plan(3, shape[3], shape[1])
    assert plan.instance == "cluster"
    for row in _gru_bwd_rows(shape, reverse, dev):
        _check_bwd_row(*row, reverse, shape[1], plan)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bwd_tile_past_the_batch(dev, cell, monkeypatch):
    """The plan of the training shape (C=8, BT=18 at H=256) on batches
    below and past one tile (7 and 37 rows, a ragged last tile), both
    directions, against the twins."""
    G = 4 if cell == "lstm" else 3
    plan = _bwd_plan(G, 256, 256)
    assert (plan.instance, plan.C, plan.BT) == ("cluster", 8, 18)
    monkeypatch.setattr(rnn_plan, "bwd_plan", lambda *a, **k: plan)
    rows = _lstm_bwd_rows if cell == "lstm" else _gru_bwd_rows
    for B in (7, 37):
        for reverse in (False, True):
            for fn, plain, args, kw in rows((9, B, 24, 256), reverse, dev):
                got = fn(*args, reverse=reverse, **kw)
                want = plain(*args, reverse=reverse, **kw)
                torch.cuda.synchronize()
                if "scan" in fn.__name__:
                    for g, w in zip(got, want):
                        assert _rel_err(g, w) < 1e-4
                else:
                    assert got[3].shape[0] == -(-B // 18)
                    _check_partials(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_at_512(dev, reverse):
    """H=512: the LSTM's chain fits no cluster plan (its gate rows of 32
    units take 256 KB) and takes the L2 instance, counted as such; the
    GRU's three rows of 32 units (192 KB) fit at C=16, and its cluster
    plan is held against the twins and the forced L2 instance."""
    shape = (20, 9, 64, 512)
    assert _bwd_plan(4, 512, 9).instance == "l2"
    for fn, plain, args, kw in _lstm_bwd_rows(shape, reverse, dev):
        n = _counts(fn)
        got = fn(*args, reverse=reverse, **kw)
        want = plain(*args, reverse=reverse, **kw)
        torch.cuda.synchronize()
        assert _counts(fn) == dict(n, l2=n["l2"] + 1)
        if "scan" in fn.__name__:
            for g, w in zip(got, want):
                assert _rel_err(g, w) < 1e-4
        else:
            _check_partials(got, want)
    plan = _bwd_plan(3, 512, 9)
    assert plan.instance == "cluster" and plan.C == 16
    for row in _gru_bwd_rows(shape, reverse, dev):
        _check_bwd_row(*row, reverse, 9, plan)


def test_bwd_cluster_kernel_refuses_a_bad_plan(dev, monkeypatch):
    """The backward entry points check the plan they are given before any
    launch: a byte count that is not the layout's, rows a lane with no
    instance (3, 11), a tile past 32 rows or 3 output units a lane raise;
    the same plan runs."""
    fn, plain, args, kw = _lstm_bwd_rows((5, 8, 16, 32), False, dev)[0]
    good = _bwd_plan(4, 32, 8)
    assert good.instance == "cluster"
    for bad in (good._replace(smem=good.smem + 16), good._replace(RB=11),
                good._replace(RB=3), good._replace(BT=33),
                good._replace(KS=3)):
        monkeypatch.setattr(rnn_plan, "bwd_plan",
                            lambda *a, _p=bad, **k: _p)
        with pytest.raises(RuntimeError, match="invalid argument"):
            fn(*args, **kw)
    monkeypatch.setattr(rnn_plan, "bwd_plan", lambda *a, **k: good)
    _check_partials(fn(*args, **kw), plain(*args, **kw))


# The two GEMMs (ops/gemm.py, csrc/gemm.cuh): (M, N, K) of the gate product
# and (N1, N2, K rows, B) of the atb product at the repo's cells (mLstm
# and mGru training, the trainer defaults at size 384, the basecall batch,
# the remap model's H=96) and at ragged widths (D = 7, H = 17: the simt
# instance), each on both instances where TMA takes it.
GEMM_GATE_SHAPES = [(204800, 1024, 256), (204800, 256, 1024),
                    (512000, 768, 256), (204600, 1536, 384),
                    (204600, 384, 1536), (128000, 1024, 256),
                    (256000, 384, 96), (256000, 96, 384), (481, 64, 7),
                    (481, 7, 64), (100, 51, 17), (1000, 300, 100),
                    (129, 8, 4)]
GEMM_ATB_SHAPES = [(1024, 256, 204800, 256), (768, 256, 512000, 256),
                   (1536, 384, 204600, 341), (384, 96, 256000, 256),
                   (64, 7, 481, 13), (51, 17, 100, 5), (132, 260, 4100, 41)]
GEMM_TOL = 1e-5   # of the largest |output|


def _gemm_rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def _gemm_instances(kind, M, N, K):
    return ("simt", "tc") if gemm.tc_takes(kind, M, N, K) else ("simt",)


@pytest.mark.parametrize("shape", GEMM_GATE_SHAPES)
def test_gate_gemm_instances_match_twin_and_f64(dev, shape):
    """Each instance within GEMM_TOL of its twin (torch.matmul on the
    card) and of an f64 product, with bias, and added onto a C (the
    recomputing LSTM backward's second product); small shapes also with
    neither."""
    M, N, K = shape
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    A = torch.randn(M, K, device=dev, generator=g)
    W = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
    bias = torch.randn(N, device=dev, generator=g)
    C = torch.randn(M, N, device=dev, generator=g)
    cases = [(bias, None), (bias, C)]
    if M * N * K < 1e9:
        cases.append((None, None))
    for b, c in cases:
        ref = A.double() @ W.double().t()
        ref = ref + (0 if b is None else b.double()) + (
            0 if c is None else c.double())
        want = gemm.gate_gemm_plain(A, W, b, c)
        for inst in _gemm_instances(gemm.GATE, M, N, K):
            n = _counts(gemm.gate_gemm)
            got = gemm.gate_gemm(A, W, b, None if c is None else c.clone(),
                                 instance=inst)
            torch.cuda.synchronize()
            assert _counts(gemm.gate_gemm) == dict(n, **{inst: n[inst] + 1})
            assert got.shape == (M, N)
            assert _gemm_rel(got, want) < GEMM_TOL, (inst, b is None, c)
            assert _gemm_rel(got, ref) < GEMM_TOL, inst
            del got
        del ref, want


@pytest.mark.parametrize("shape", GEMM_ATB_SHAPES)
def test_atb_gemm_instances_match_twin_and_f64(dev, shape):
    """Each instance's partials within GEMM_TOL of the twin's on the same
    slices, their sum of an f64 product, at shifts -B, 0 and +B (rows of
    B read across the slices' edges and past both ends as zero), on the
    plan's slices, and the tc instance also on 5 asked for (slices of up
    to 102,400 rows; the simt kernel's f32 FMA chain, its plan's slices at
    most 16,000 rows, drifts past 1e-5 of the largest output on slices of
    40,960)."""
    N1, N2, K, B = shape
    g = torch.Generator(device=dev).manual_seed(N1 + N2 + K)
    A = torch.randn(K, N1, device=dev, generator=g)
    Bm = torch.randn(K, N2, device=dev, generator=g)
    sms = gemm.card_sms(torch.cuda.current_device())
    for shift in (-B, 0, B):
        ref = A.double().t() @ gemm.shifted(Bm, shift).double()
        for inst in _gemm_instances(gemm.ATB, N1, N2, K):
            for nsplit in ((None, 5) if inst == "tc" else (None,)):
                plan = gemm.gemm_plan(N1, N2, K, gemm.ATB, sms, inst,
                                      nsplit)
                n = _counts(gemm.atb_gemm)
                got = gemm.atb_gemm(A, Bm, shift, nsplit, instance=inst)
                torch.cuda.synchronize()
                assert _counts(gemm.atb_gemm) == dict(
                    n, **{inst: n[inst] + 1})
                assert got.shape == (plan.nsplit, N1, N2)
                want = gemm.atb_gemm_plain(A, Bm, shift, plan.nsplit,
                                           plan.kslice)
                assert _gemm_rel(got, want) < GEMM_TOL, (inst, shift)
                assert _gemm_rel(got.sum(0), ref) < GEMM_TOL, (inst, shift)
                del got, want


def test_atb_gemm_repeats_bit_for_bit(dev):
    A = torch.randn(51200, 1024, device=dev)
    Bm = torch.randn(51200, 256, device=dev)
    first = gemm.atb_gemm(A, Bm, -256)
    assert torch.equal(first, gemm.atb_gemm(A, Bm, -256))


def test_gemms_reject_bad_input(dev):
    A = torch.randn(64, 32, device=dev)
    W = torch.randn(48, 32, device=dev)
    with pytest.raises(ValueError):
        gemm.gate_gemm(A.t(), W)                     # not contiguous
    with pytest.raises(ValueError):
        gemm.gate_gemm(A, W[:, :16].contiguous())    # K differs
    with pytest.raises(ValueError):
        gemm.gate_gemm(A.double(), W)
    with pytest.raises(ValueError):
        gemm.gate_gemm(A, W, torch.randn(47, device=dev))
    with pytest.raises(ValueError):
        gemm.gate_gemm(A, W, C=torch.randn(64, 47, device=dev))
    with pytest.raises(ValueError):
        gemm.gate_gemm(A, W.cpu())
    with pytest.raises(ValueError):
        gemm.atb_gemm(A, W)                          # rows differ
    with pytest.raises(ValueError):                  # TMA cannot take D=7
        gemm.gate_gemm(torch.randn(64, 7, device=dev),
                       torch.randn(48, 7, device=dev), instance="tc")


def test_gemm_entry_points_refuse_a_bad_plan(dev):
    """The C side checks each plan before any launch: an atb slice that is
    not whole k tiles, slices that leave rows out or an empty slice, a
    simt slice length that is not ceil(K / nsplit), a tc plan on rows of
    7 floats or on a base off 16 bytes, an unknown instance, no CTAs:
    cudaErrorInvalidValue (1), and the output untouched."""
    from taiyaki_tpu_torch.ops import cuda_lib
    lib = cuda_lib.load("gemm", gemm._SIGNATURES)
    st = torch.cuda.current_stream().cuda_stream
    K, N1, N2 = 1000, 64, 32
    A = torch.randn(K + 1, N1, device=dev)
    B = torch.randn(K, N2, device=dev)
    good = gemm.gemm_plan(N1, N2, K, gemm.ATB, 132, "tc", 3)
    out = torch.zeros(8, N1, N2, device=dev)
    for bad in (good._replace(kslice=good.kslice + 1),
                good._replace(nsplit=good.nsplit - 1),
                good._replace(nsplit=good.nsplit + 1),
                good._replace(instance="simt"), good._replace(ctas=0)):
        assert lib.tt_atb_gemm(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                               K, N1, N2, 0, 0, gemm.c_args([bad]), st) == 1
    assert lib.tt_atb_gemm(A.data_ptr() + 4, B.data_ptr(), out.data_ptr(),
                           K, N1, N2, 0, 0, gemm.c_args([good]), st) == 1
    unknown = gemm.c_args([good])
    unknown[0] = 2
    assert lib.tt_atb_gemm(A.data_ptr(), B.data_ptr(), out.data_ptr(), K,
                           N1, N2, 0, 0, unknown, st) == 1
    Ar = torch.randn(100, 7, device=dev)
    Wr = torch.randn(9, 7, device=dev)
    tc = gemm.gemm_plan(100, 9, 8, gemm.GATE, 132, "tc")
    assert lib.tt_gate_gemm(Ar.data_ptr(), Wr.data_ptr(), None,
                            out.data_ptr(), 100, 9, 7, 0, 0, 0,
                            gemm.c_args([tc]), st) == 1
    torch.cuda.synchronize()
    assert not out.any()
    assert lib.tt_atb_gemm(A.data_ptr(), B.data_ptr(), out.data_ptr(), K,
                           N1, N2, 0, 0, gemm.c_args([good]), st) == 0
    torch.cuda.synchronize()
    assert out.any()


def test_layers_count_their_gemms_by_instance(dev):
    """A layer's products go to the plan's instance: at D=7 the input
    product (K=7) and d_iW (N2=7) take the simt instance, the rest tc."""
    T, B, D, H = 37, 13, 7, 16
    args = _lstm_bwd_inputs((T, B, D, H), False, dev)
    gates, atbs = _counts(gemm.gate_gemm), _counts(gemm.atb_gemm)
    lstm.lstm_fwd(*[a.to(dev) for a in _lstm_inputs(T, B, D, H)])
    lstm.lstm_bwd_acts(*args)
    torch.cuda.synchronize()
    assert _counts(gemm.gate_gemm) == dict(simt=gates["simt"] + 1,
                                           tc=gates["tc"] + 1)
    assert _counts(gemm.atb_gemm) == dict(simt=atbs["simt"] + 1,
                                          tc=atbs["tc"] + 1)


def _offset(t):
    """t as a contiguous view at an odd 4-byte offset of a fresh buffer
    (never 16-byte aligned there), holding t's values."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.view(t.shape).copy_(t)


def _offset_all(args):
    return [_offset(a) if isinstance(a, torch.Tensor) else a for a in args]


def _same_outputs(got, want, rel=1e-4):
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        assert g.shape == w.shape
        assert _rel_err(g, w) < rel


@pytest.mark.parametrize("reverse", [False, True])
def test_offset_views_run_as_aligned(dev, reverse):
    """Every input a contiguous view at an odd float offset (4-byte, not
    16-byte aligned): the layers' forwards and backwards (whose GEMMs take
    the tc instance at these widths: their operands get aligned copies),
    the logZ forward and posteriors (4-byte loads) and the CRF forward and
    backward run on the card and give the aligned call's results within
    the kernels' tolerances (1e-4 relative for the layers)."""
    shape = (40, 24, 32, 64)
    args = [a.to(dev) for a in _lstm_inputs(*shape)]
    for emit in (None, "acts"):
        _same_outputs(lstm.lstm_fwd(*_offset_all(args), reverse=reverse,
                                    emit=emit),
                      lstm.lstm_fwd(*args, reverse=reverse, emit=emit))
    x, iW, b, sW, _ = (a.to(dev) for a in _gru_inputs(*shape))
    for res in (False, True):
        _same_outputs(gru.gru_fwd(*_offset_all((x, iW, b, sW)),
                                  reverse=reverse, emit_residuals=res),
                      gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                                  emit_residuals=res))
    rows = _lstm_bwd_rows(shape, reverse, dev) + _gru_bwd_rows(
        shape, reverse, dev)
    for fn, _, a, kw in rows:
        got = fn(*_offset_all(a), reverse=reverse,
                 **{k: _offset(v) for k, v in kw.items()})
        _same_outputs(got, fn(*a, reverse=reverse, **kw))

    s = _scores(300, 7, 4).to(dev)
    f0, z0, l0 = logz.logz_fwd(s)
    f1, z1, l1 = logz.logz_fwd(_offset(s))
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-4)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)
    torch.testing.assert_close(logz.logz_posteriors(_offset(s), _offset(l0)),
                               logz.logz_posteriors(s, l0), rtol=0,
                               atol=1e-5)

    crf_args = _crf_inputs(60, 5, 45, nmod=6, dev=dev)
    lp, sidx, midx, mmidx, mfact, valid, last = crf_args
    f0, s0, lat0 = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
    f1, s1, lat1 = crf.crf_fwd(*_offset_all(crf_args[:6]))
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4) and _lattice_close(f1, f0, 1e-4)
    g0 = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat0, valid, last)
    g1 = crf.crf_bwd(*_offset_all((lp, sidx, midx, mmidx, mfact, lat0,
                                   valid, last)))
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-5 * mfact.max().item())


def test_squiggle_cost_card_matches_cpu(dev):
    """The squiggle-match cost (ops/squiggle.py, plain PyTorch ops, no
    kernel of its own) and its gradient on the card against the CPU:
    costs 1e-5 relative, the gradient 1e-4 of its largest (f32 through
    the recursion in another order); a padded batch."""
    from taiyaki_tpu_torch.ops import squiggle
    rng = np.random.default_rng(4)
    npos, nbatch, nsample = 40, 5, 150
    params = rng.normal(size=(npos, nbatch, 3)).astype(np.float32)
    params[:, :, 1] = -np.abs(params[:, :, 1]) * 0.5
    signals = torch.from_numpy(
        rng.normal(size=(nsample, nbatch)).astype(np.float32))
    siglens = torch.tensor([150, 149, 120, 90, 150])
    out = []
    for d in (torch.device("cpu"), dev):
        p = torch.tensor(params, device=d, requires_grad=True)
        cost = squiggle.squiggle_match_cost(p, signals.to(d),
                                            siglens.to(d), 1e-15)
        (grad,) = torch.autograd.grad(cost.sum(), p)
        out.append((cost.detach().cpu(), grad.cpu()))
    (cost, grad), (dcost, dgrad) = out
    assert torch.isfinite(dcost).all() and torch.isfinite(dgrad).all()
    torch.testing.assert_close(dcost, cost, rtol=1e-5, atol=0)
    assert (dgrad - grad).abs().max() <= 1e-4 * grad.abs().max()


# -- the bf16 instances (TAIYAKI_TPU_BF16_STREAMS=1) ---------------------------
#
# Kernels 1, 4, 11 and 12 with bf16 residuals, h and dh, and x in either
# dtype, on both chain instances, against their twins on the card (which
# round where the kernels store): f32 outputs at the f32 instances'
# tolerances (h atol 1e-4; backwards 1e-4 relative, weight partials
# summed); bf16 outputs equal as bf16 but for at most 1% of them one bf16
# step apart, or 1e-4 (relative to the largest, for d_x) where a step is
# smaller.  The GEMMs with a bf16 operand within GEMM_TOL of their twins
# and of the f64 product of the widened operands (the widening is exact);
# with a bf16 output equal as bf16 but for single steps.

BF16 = torch.bfloat16
# ragged widths (the simt GEMMs), the mLstm width, the trainer's 384 on a
# batch not a multiple of 8, and H=512 (the L2 instance by plan)
BF16_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (50, 24, 64, 256),
               (120, 37, 384, 384), (20, 16, 64, 512)]
BF16_SHARE = 0.01


def _bf16_close(got, want, atol):
    """Equal as bf16 but for at most BF16_SHARE of the elements, each at
    most one bf16 step (of the larger magnitude) or `atol` apart."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(
        torch.maximum(g.abs(), w.abs()))[1] - 8)
    diff = (g - w).abs()
    assert bool((diff <= step.clamp(min=atol)).all()), diff.max().item()
    assert (diff > 0).float().mean().item() <= BF16_SHARE


def _bf16_counts(fn):
    return {k: c.launches for k, c in fn.bf16_by_instance.items()}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_lstm_bf16_fwd_matches_twin(dev, shape, reverse):
    """Kernel 1's bf16 instance in every emit mode, h in bf16 or f32, x in
    f32 or bf16, on the plan's instance and the forced L2 one."""
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(*shape))
    for xdt in (torch.float32, BF16):
        xx = x.to(xdt)
        for hdt in (BF16, torch.float32):
            for emit in lstm.EMITS:
                want = _as_tuple(lstm.lstm_fwd_plain(
                    xx, iW, b, sW, reverse, emit, hdt, BF16))
                for inst in (None, "l2"):
                    n, nb = _counts(lstm.lstm_fwd), lstm.lstm_fwd.bf16.launches
                    got = _as_tuple(lstm.lstm_fwd(
                        xx, iW, b, sW, reverse=reverse, emit=emit,
                        instance=inst, h_dtype=hdt, res_dtype=BF16))
                    torch.cuda.synchronize()
                    assert lstm.lstm_fwd.bf16.launches == nb + 1
                    ran = {k for k, v in _counts(lstm.lstm_fwd).items()
                           if v != n[k]}
                    assert len(ran) == 1 and (inst is None or ran == {inst})
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        if g.dtype == BF16:
                            _bf16_close(g, w, 1e-4)
                        else:
                            assert (g - w).abs().max().item() < 1e-4


def _bf16_bwd_rows(shape, reverse, dev, xdt, hdt, dhdt):
    """(wrapper, twin, args) of kernels 4, 11 and 12 on the bf16
    forward's residuals, x, h and dh of the dtypes given."""
    T, B, D, H = shape
    x, iW, b, sW = (a.to(dev) for a in _lstm_inputs(*shape))
    x = x.to(xdt)
    h, c, acts, tc = lstm.lstm_fwd_plain(x, iW, b, sW, reverse, "acts", hdt,
                                         BF16)
    pre = lstm.lstm_fwd_plain(x, iW, b, sW, reverse, "pre", hdt, BF16)[2]
    dh = torch.from_numpy(np.random.default_rng(9).normal(
        size=(T, B, H)).astype(np.float32)).to(dev).to(dhdt)
    c_prev = lstm.prev_state(c, reverse)
    return [(lstm.lstm_bwd_acts, lstm.lstm_bwd_acts_plain,
             (dh, acts, tc, c_prev, h, x, sW, iW)),
            (lstm.lstm_bwd_fusedw, lstm.lstm_bwd_fusedw_plain,
             (dh, pre, c, c_prev, h, x, sW, iW)),
            (lstm.lstm_bwd_recompute, lstm.lstm_bwd_recompute_plain,
             (dh, c, h, x, sW, iW, b))]


def _check_bf16_bwd(got, want):
    assert got[0].dtype == want[0].dtype
    if got[0].dtype == BF16:
        _bf16_close(got[0], want[0],
                    1e-4 * max(1.0, want[0].float().abs().max().item()))
    else:
        assert _rel_err(got[0], want[0]) < 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and g.shape[1:] == w.shape[1:]
        assert _rel_err(g.sum(0), w.sum(0)) < 1e-4


# (x, h, dh): a later layer (all bf16), the first layer (x f32), dh kept
# f32 (TAIYAKI_TPU_F32_GRADS=1 beside an f32 h), h f32 (F32_GATES=1)
BF16_BWD_DTYPES = [(BF16, BF16, BF16), (torch.float32, BF16, BF16),
                   (torch.float32, torch.float32, torch.float32),
                   (torch.float32, torch.float32, BF16)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_lstm_bf16_bwd_matches_twin(dev, shape, reverse):
    """Kernels 4, 11 and 12's bf16 instances on the plan's chain instance
    and the forced L2 one; their inputs left as they were."""
    for dts in BF16_BWD_DTYPES:
        for fn, plain, args in _bf16_bwd_rows(shape, reverse, dev, *dts):
            kept = [a.clone() for a in args]
            want = plain(*args, reverse=reverse)
            for inst in (None, "l2"):
                n, nb = _counts(fn), _bf16_counts(fn)
                got = fn(*args, reverse=reverse, instance=inst)
                torch.cuda.synchronize()
                ran = {k for k, v in _bf16_counts(fn).items() if v != nb[k]}
                assert _counts(fn) != n and len(ran) == 1 \
                    and (inst is None or ran == {inst})
                _check_bf16_bwd(got, want)
            assert all(torch.equal(a, k) for a, k in zip(args, kept))


def test_bf16_instances_on_both_chain_instances(dev):
    """At the mLstm shape the plans take the cluster instances; H=512 the
    L2 ones: the bf16 launches land on each."""
    for shape, inst in (((50, 24, 64, 256), "cluster"),
                        ((20, 16, 64, 512), "l2")):
        assert _plan(4, shape[3], shape[1]).instance == inst
        assert _bwd_plan(4, shape[3], shape[1]).instance == inst
        for fn, _, args in _bf16_bwd_rows(shape, False, dev, BF16, BF16,
                                          BF16):
            nb = _bf16_counts(fn)
            fn(*args)
            assert _bf16_counts(fn) == dict(nb, **{inst: nb[inst] + 1})


BF16_GATE_SHAPES = [(204800, 1024, 256), (256000, 1536, 384), (481, 64, 16),
                    (481, 64, 12), (1000, 300, 100)]
BF16_ATB_SHAPES = [(1024, 256, 204800, 256), (1536, 384, 102400, 256),
                   (64, 16, 481, 13), (64, 12, 481, 13), (51, 17, 100, 5)]


def _bf16_gemm_instances(kind, M, N, K):
    return (("simt", "tc") if gemm.tc_takes(kind, M, N, K, bf16=True)
            else ("simt",))


@pytest.mark.parametrize("shape", BF16_GATE_SHAPES)
def test_gate_gemm_bf16_matches_twin_and_f64(dev, shape):
    """A bf16 A (x or h_prev), with bias and added onto C; and an f32 A
    with a bf16 output (d_x)."""
    M, N, K = shape
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    A = torch.randn(M, K, device=dev, generator=g).to(BF16)
    W = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
    bias = torch.randn(N, device=dev, generator=g)
    C = torch.randn(M, N, device=dev, generator=g)
    for c in (None, C):
        ref = A.double() @ W.double().t() + bias.double() + (
            0 if c is None else c.double())
        want = gemm.gate_gemm_plain(A, W, bias, c)
        for inst in _bf16_gemm_instances(gemm.GATE, M, N, K):
            nb = gemm.gate_gemm.bf16.launches
            got = gemm.gate_gemm(A, W, bias, None if c is None else c.clone(),
                                 instance=inst)
            torch.cuda.synchronize()
            assert gemm.gate_gemm.bf16.launches == nb + 1
            assert got.dtype == torch.float32
            assert _gemm_rel(got, want) < GEMM_TOL, (inst, c is None)
            assert _gemm_rel(got, ref) < GEMM_TOL, inst
        del ref, want
    Af = A.float()
    want = gemm.gate_gemm_plain(Af, W, None, None, BF16)
    for inst in gemm.INSTANCES if gemm.tc_takes(gemm.GATE, M, N, K) \
            else ("simt",):
        got = gemm.gate_gemm(Af, W, instance=inst, out_dtype=BF16)
        torch.cuda.synchronize()
        _bf16_close(got, want, 1e-5 * want.float().abs().max().item())
    with pytest.raises(ValueError):
        gemm.gate_gemm(A, W, out_dtype=BF16)
    with pytest.raises(ValueError):
        gemm.gate_gemm(Af, W, C=C, out_dtype=BF16)


@pytest.mark.parametrize("shape", BF16_ATB_SHAPES)
def test_atb_gemm_bf16_matches_twin_and_f64(dev, shape):
    """A bf16 B (x, or h read by a row shift) at shifts -B, 0 and +B, on
    the plan's slices."""
    N1, N2, K, B = shape
    g = torch.Generator(device=dev).manual_seed(N1 + N2 + K)
    A = torch.randn(K, N1, device=dev, generator=g)
    Bm = torch.randn(K, N2, device=dev, generator=g).to(BF16)
    sms = gemm.card_sms(torch.cuda.current_device())
    for shift in (-B, 0, B):
        ref = A.double().t() @ gemm.shifted(Bm.float(), shift).double()
        for inst in _bf16_gemm_instances(gemm.ATB, N1, N2, K):
            plan = gemm.gemm_plan(N1, N2, K, gemm.ATB, sms, inst, bf16=True)
            got = gemm.atb_gemm(A, Bm, shift, instance=inst)
            torch.cuda.synchronize()
            assert got.shape == (plan.nsplit, N1, N2)
            want = gemm.atb_gemm_plain(A, Bm, shift, plan.nsplit,
                                       plan.kslice)
            assert _gemm_rel(got, want) < GEMM_TOL, (inst, shift)
            assert _gemm_rel(got.sum(0), ref) < GEMM_TOL, (inst, shift)
            del got, want


BF16_POLICIES = [{}, {"TAIYAKI_TPU_ACTS_BWD": "0"},
                 {"TAIYAKI_TPU_RECOMPUTE": "1"}]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("env", BF16_POLICIES)
def test_lstm_layers_bf16_streams_on_card(dev, env, reverse, monkeypatch):
    """Two stacked layers under the switch on the card against the same
    on the CPU (the twins): h equal as bf16 but for single steps; every
    gradient within one bf16 step (2^-8) of its largest, since the second
    layer's d_x is a bf16 stream whose single steps against the CPU's
    carry into the first layer's gradients (2e-4 to 4e-4 seen); each
    layer's launches of its bf16 instance, and the GEMMs' with bf16
    operands (no f32 copy of x or h: the layer's GEMMs take them as they
    are)."""
    for name in ("TAIYAKI_TPU_ACTS_BWD", "TAIYAKI_TPU_RECOMPUTE",
                 "TAIYAKI_TPU_NO_RECOMPUTE", "TAIYAKI_TPU_F32_GATES",
                 "TAIYAKI_TPU_BF16_ACTS", "TAIYAKI_TPU_F32_GRADS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    x, iW, b, sW = _lstm_inputs(41, 16, 24, 32)
    iW2 = torch.from_numpy((np.random.default_rng(6).normal(
        size=(128, 32)) / np.sqrt(32)).astype(np.float32))
    dh = torch.from_numpy(np.random.default_rng(5).normal(
        size=(41, 16, 32)).astype(np.float32))
    out = {}
    bwd = _policy_kernel("lstm")
    for device in ("cpu", dev):
        leaves = [a.to(device).requires_grad_() for a in (x, iW, b, sW, iW2)]
        n = (lstm.lstm_fwd.bf16.launches,
             getattr(lstm, bwd).bf16.launches,
             gemm.gate_gemm.bf16.launches, gemm.atb_gemm.bf16.launches)
        h1 = rnn.lstm_layer(*leaves[:4], reverse=reverse)
        h2 = rnn.lstm_layer(h1, leaves[4], leaves[2], leaves[3],
                            reverse=not reverse)
        grads = torch.autograd.grad(h2, leaves, dh.to(device).to(BF16))
        assert h1.dtype == h2.dtype == BF16
        out[str(device)] = [h2.detach().cpu()] + [g.cpu() for g in grads]
        if device != "cpu":
            torch.cuda.synchronize()
            assert (lstm.lstm_fwd.bf16.launches - n[0],
                    getattr(lstm, bwd).bf16.launches - n[1]) == (2, 2)
            assert gemm.gate_gemm.bf16.launches > n[2]
            assert gemm.atb_gemm.bf16.launches > n[3]
    cpu, card = out["cpu"], out[str(dev)]
    _bf16_close(card[0], cpu[0], 1e-4)
    for g, w in zip(card[1:], cpu[1:]):
        assert g.dtype == w.dtype == torch.float32
        assert _rel_err(g, w) < 2.0 ** -8


def test_bf16_refused_on_card(dev, monkeypatch):
    """A bf16 tensor given to a kernel with no bf16 instance, or bf16 x or
    h to the f32 instance, raises before any launch; under the switch the
    scans run their bf16 instances (since ROADMAP.md Queue 1 item 7.2),
    with the JAX scans' dtypes: h f32, both gradients f32."""
    x, iW, b, sW = (a.to(dev) for a in _gru_inputs(9, 8, 12, 16)[:4])
    with pytest.raises(ValueError):
        gru.gru_fwd(x.to(BF16), iW, b, sW)
    with pytest.raises(ValueError):
        lstm.lstm_scan_fwd(torch.zeros(9, 8, 64, device=dev, dtype=BF16),
                           torch.zeros(64, 16, device=dev))
    xl, iWl, bl, sWl = (a.to(dev) for a in _lstm_inputs(9, 8, 12, 16))
    with pytest.raises(ValueError):
        lstm.lstm_fwd(xl.to(BF16), iWl, bl, sWl)
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    for scan, G in ((rnn.lstm_scan, 4), (rnn.gru_scan, 3)):
        fwd = lstm.lstm_scan_fwd if G == 4 else gru.gru_scan_fwd
        n = fwd.bf16.launches
        leaves = [torch.zeros(9, 8, G * 16, device=dev).requires_grad_(),
                  torch.full((G * 16, 16), 0.1, device=dev).requires_grad_()]
        h = scan(*leaves)
        grads = torch.autograd.grad(h, leaves, torch.ones_like(h))
        torch.cuda.synchronize()
        assert fwd.bf16.launches == n + 1
        assert h.dtype == torch.float32
        assert [g.dtype for g in grads] == [torch.float32] * 2


# -- the GRU's bf16 instances ------------------------------------------------
#
# Kernels 7, 8 and 13 with bf16 residuals, h and dh, and x in either
# dtype, on both chain instances, against their twins on the card, on the
# terms of the LSTM's above.  Ragged widths take the simt GEMMs; H=96 is
# train_abinitio's width (3H = 288); at H=512 the forward's plan takes the
# L2 instance.

BF16_GRU_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (50, 24, 64, 256),
                   (40, 16, 96, 96), (120, 37, 384, 384), (20, 16, 64, 512)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_GRU_SHAPES)
def test_gru_bf16_fwd_matches_twin(dev, shape, reverse):
    """Kernel 7's bf16 instance with and without its residuals (gh and a
    bf16 copy of gx), h in bf16 or f32, x in f32 or bf16, on the plan's
    instance and the forced L2 one."""
    x, iW, b, sW = (a.to(dev) for a in _gru_inputs(*shape)[:4])
    for xdt in (torch.float32, BF16):
        xx = x.to(xdt)
        for hdt in (BF16, torch.float32):
            for res in (False, True):
                want = _as_tuple(gru.gru_fwd_plain(xx, iW, b, sW, reverse,
                                                   res, hdt, BF16))
                for inst in (None, "l2"):
                    n, nb = _counts(gru.gru_fwd), gru.gru_fwd.bf16.launches
                    got = _as_tuple(gru.gru_fwd(
                        xx, iW, b, sW, reverse=reverse, emit_residuals=res,
                        instance=inst, h_dtype=hdt, res_dtype=BF16))
                    torch.cuda.synchronize()
                    assert gru.gru_fwd.bf16.launches == nb + 1
                    ran = {k for k, v in _counts(gru.gru_fwd).items()
                           if v != n[k]}
                    assert len(ran) == 1 and (inst is None or ran == {inst})
                    assert len(got) == len(want) == (3 if res else 1)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        if g.dtype == BF16:
                            _bf16_close(g, w, 1e-4)
                        else:
                            assert (g - w).abs().max().item() < 1e-4


def _bf16_gru_bwd_rows(shape, reverse, dev, xdt, hdt, dhdt):
    """(wrapper, twin, args) of kernels 8 and 13 on the bf16 forward's
    residuals, x, h and dh of the dtypes given."""
    x, iW, b, sW, dh = (a.to(dev) for a in _gru_inputs(*shape))
    x = x.to(xdt)
    h, gh, gx = gru.gru_fwd_plain(x, iW, b, sW, reverse, True, hdt, BF16)
    dh = dh.to(dhdt)
    return [(gru.gru_bwd_recompute, gru.gru_bwd_recompute_plain,
             (dh, h, x, sW, iW, b)),
            (gru.gru_bwd_fusedw, gru.gru_bwd_fusedw_plain,
             (dh, gx, gh, lstm.prev_state(h, reverse), x, sW, iW))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_GRU_SHAPES)
def test_gru_bf16_bwd_matches_twin(dev, shape, reverse):
    """Kernels 8 and 13's bf16 instances on the plan's chain instance and
    the forced L2 one, in each case of BF16_BWD_DTYPES; the recompute
    with every stream f32 runs its f32 instance (it stores no residuals);
    their inputs left as they were."""
    for dts in BF16_BWD_DTYPES:
        for fn, plain, args in _bf16_gru_bwd_rows(shape, reverse, dev,
                                                  *dts):
            bf16 = fn is gru.gru_bwd_fusedw or BF16 in dts
            kept = [a.clone() for a in args]
            want = plain(*args, reverse=reverse)
            for inst in (None, "l2"):
                n, nb = _counts(fn), _bf16_counts(fn)
                got = fn(*args, reverse=reverse, instance=inst)
                torch.cuda.synchronize()
                ran = {k for k, v in _counts(fn).items() if v != n[k]}
                ran16 = {k for k, v in _bf16_counts(fn).items()
                         if v != nb[k]}
                assert len(ran) == 1 and (inst is None or ran == {inst})
                assert ran16 == (ran if bf16 else set())
                _check_bf16_bwd(got, want)
            assert all(torch.equal(a, k) for a, k in zip(args, kept))


def test_gru_bf16_instances_on_both_chain_instances(dev):
    """At the mGru width and train_abinitio's the plans take the cluster
    instances; at H=512 the forward's plan the L2 one (the GRU's backward
    slice still fits a cluster of 16): the bf16 launches land on the
    plans' instances."""
    for shape, inst, bwd_inst in (((50, 24, 64, 256), "cluster", "cluster"),
                                  ((40, 16, 96, 96), "cluster", "cluster"),
                                  ((20, 16, 64, 512), "l2", "cluster")):
        assert _plan(3, shape[3], shape[1]).instance == inst
        assert _bwd_plan(3, shape[3], shape[1]).instance == bwd_inst
        x, iW, b, sW = (a.to(dev) for a in _gru_inputs(*shape)[:4])
        nb = _bf16_counts(gru.gru_fwd)
        gru.gru_fwd(x.to(BF16), iW, b, sW, h_dtype=BF16, res_dtype=BF16)
        assert _bf16_counts(gru.gru_fwd) == dict(nb, **{inst: nb[inst] + 1})
        for fn, _, args in _bf16_gru_bwd_rows(shape, False, dev, BF16, BF16,
                                              BF16):
            nb = _bf16_counts(fn)
            fn(*args)
            assert _bf16_counts(fn) == dict(
                nb, **{bwd_inst: nb[bwd_inst] + 1})


GRU_BF16_POLICIES = [{}, {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}]


@pytest.mark.parametrize("xdt", [torch.float32, BF16], ids=["x32", "x16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("env", GRU_BF16_POLICIES)
def test_gru_layers_bf16_streams_on_card(dev, env, reverse, xdt,
                                         monkeypatch):
    """One GRU layer under the switch on the card against the same on the
    CPU (the twins), as the first layer (x f32) and as a later one (x
    bf16), under each policy: h equal as bf16 but for single steps (the
    same inputs: the kernels' terms against their twins), every gradient
    within one bf16 step (2^-8) of its largest (the backward reads the
    forward's bf16 h, which may differ by single steps); the layer's
    launches of its bf16 instances, and the GEMMs' with bf16 operands.  A
    stack of layers is held on the card against the f32 step instead
    (chip_smoke.py phase 17b): a single step in one layer's h moves the
    next layer's by more than one."""
    for name in ("TAIYAKI_TPU_RECOMPUTE", "TAIYAKI_TPU_NO_RECOMPUTE",
                 "TAIYAKI_TPU_F32_GATES", "TAIYAKI_TPU_BF16_ACTS",
                 "TAIYAKI_TPU_F32_GRADS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    x, iW, b, sW, _ = _gru_inputs(41, 16, 24, 32)
    dh = torch.from_numpy(np.random.default_rng(5).normal(
        size=(41, 16, 32)).astype(np.float32))
    out = {}
    bwd = _policy_kernel("gru")
    # a bf16 operand: gx of a bf16 x, gh rebuilt from the bf16 h
    # (recompute), d_x in bf16; d_sW of the bf16 h always
    gate16 = xdt == BF16 or bwd == "gru_bwd_recompute"
    for device in ("cpu", dev):
        leaves = [x.to(device).to(xdt).requires_grad_()] + [
            a.to(device).requires_grad_() for a in (iW, b, sW)]
        n = (gru.gru_fwd.bf16.launches, getattr(gru, bwd).bf16.launches,
             gemm.gate_gemm.bf16.launches, gemm.atb_gemm.bf16.launches)
        h = rnn.gru_layer(*leaves, reverse=reverse)
        grads = torch.autograd.grad(h, leaves, dh.to(device).to(BF16))
        assert h.dtype == BF16 and grads[0].dtype == xdt
        out[str(device)] = [h.detach().cpu()] + [g.cpu() for g in grads]
        if device != "cpu":
            torch.cuda.synchronize()
            assert (gru.gru_fwd.bf16.launches - n[0],
                    getattr(gru, bwd).bf16.launches - n[1]) == (1, 1)
            assert (gemm.gate_gemm.bf16.launches > n[2]) == gate16
            assert gemm.atb_gemm.bf16.launches > n[3]
    cpu, card = out["cpu"], out[str(dev)]
    _bf16_close(card[0], cpu[0], 1e-4)
    for g, w in zip(card[1:], cpu[1:]):
        assert g.dtype == w.dtype
        assert _rel_err(g.float(), w.float()) < 2.0 ** -8


# -- the bf16 instances of rows 2, 3, 5 and 6 (the score streams) -------------
#
# bf16 scores (logZ) or bf16-rounded selected scores (the CRF), bf16
# lattices and bf16 posteriors, against their twins on the card, which
# round at the same points: logZ and the CRF score at the f32 rows'
# tolerances; a lattice or posterior row equal as bf16 but for at most 1%
# of its elements one bf16 step apart, or the f32 rows' atol (1e-4, 1e-5)
# where a step is smaller; each backward on the twin's lattice so that
# both read the same one.  The CRF's d lp sums bf16 posteriors: within
# its f32 row's atol, but for at most 1% of its entries within one bf16
# step of a posterior (2^-8, times the largest mod weight) where the
# rounding of one falls the other way.

F32 = torch.float32
SCORE_LOGZ_SHAPES = [(37, 13, 4), (800, 256, 4), (1, 5, 4), (17, 3, 4),
                     (41, 3, 1), (50, 5, 3), (33, 3, 8), (4000, 64, 4)]
# (T, B, L, mod columns, d lp atol): odd L and an odd T B L (the
# lattice's last value copied alone), cat_mod, the training shape, the
# forward's bands past 64, 2048 and 4096 positions, the widest fused
# lattice of the mGru chunk range
SCORE_CRF_SHAPES = [(37, 5, 13, 0, 1e-5), (50, 7, 37, 0, 1e-5),
                    (60, 5, 45, 6, 1e-5), (800, 256, 512, 0, 1e-5),
                    (40, 9, 65, 0, 1e-5), (300, 4, 2049, 0, 1e-5),
                    (300, 3, 4097, 3, 1e-5), (4000, 6, 3712, 0, 3e-4)]


def _bf16_states_close(got, want, atol):
    """`_bf16_close` where equal infinities count as equal."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(
        torch.maximum(g.abs(), w.abs()).nan_to_num(posinf=0.0))[1] - 8)
    diff = (g - w).abs().masked_fill(g == w, 0.0)
    assert bool((diff <= step.clamp(min=atol)).all()), diff.max().item()
    assert (diff > 0).float().mean().item() <= BF16_SHARE


@pytest.mark.parametrize("shape", SCORE_LOGZ_SHAPES)
def test_logz_bf16_matches_twin(dev, shape):
    T, B, nbase = shape
    s = _scores(T, B, nbase).to(dev).to(BF16)
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase)
    p0 = logz.logz_posteriors_plain(s, l0, nbase)
    n = (logz.logz_fwd.bf16.launches, logz.logz_posteriors.bf16.launches)
    f1, z1, l1 = logz.logz_fwd(s)
    p1 = logz.logz_posteriors(s, l0)
    p2 = logz.logz_posteriors(s, l1)
    _, z3, none = logz.logz_fwd(s, emit_lattice=False)
    torch.cuda.synchronize()
    assert (logz.logz_fwd.bf16.launches - n[0],
            logz.logz_posteriors.bf16.launches - n[1]) == (
        2 * logz.forward_kernels(T, B, nbase),
        2 * logz.posterior_kernels(T, B, nbase))
    assert l1.dtype == p1.dtype == BF16 and z1.dtype == f1.dtype == F32
    assert none is None and torch.equal(z1, z3)
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)
    _bf16_states_close(l1, l0, 1e-4)
    _bf16_states_close(p1, p0, 1e-5)
    assert bool(torch.isfinite(p2.float()).all())
    assert torch.equal(p1, logz.logz_posteriors(s, l0))


def test_logz_bf16_refuses_mixed_dtypes(dev):
    """The dtypes of no instance raise (bf16 scores with an f32 lattice,
    f32 posteriors of a bf16 lattice); f32 scores with a bf16 lattice and
    posteriors are the mixed instance's."""
    s = _scores(20, 4, 4).to(dev)
    _, _, lat = logz.logz_fwd(s.to(BF16))
    with pytest.raises(ValueError, match="no instance"):
        logz.logz_fwd(s.to(BF16), lattice_dtype=torch.float32)
    with pytest.raises(ValueError, match="no instance"):
        logz.logz_posteriors(s, lat)
    # a bf16 view at an odd offset runs (2-byte loads), as the aligned call
    off = torch.empty(s.numel() + 1, device=dev, dtype=BF16)[1:].view(
        s.shape)
    off.copy_(s)
    assert torch.equal(logz.logz_posteriors(off, lat),
                       logz.logz_posteriors(s.to(BF16), lat))


@pytest.mark.parametrize("shape", SCORE_CRF_SHAPES)
def test_crf_bf16_matches_twin(dev, shape):
    T, B, L, nmod, g_tol = shape
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        T, B, L, nmod=nmod, dev=dev)
    idx = (sidx, midx, mmidx, mfact)
    f0, s0, lat0 = crf.crf_fwd_plain(lp, *idx, valid, score_dtype=BF16)
    g0 = crf.crf_bwd_plain(lp, *idx, lat0, valid, last, score_dtype=BF16)
    n = (crf.crf_fwd.bf16.launches, crf.crf_bwd.bf16.launches)
    f1, s1, lat1 = crf.crf_fwd(lp, *idx, valid, score_dtype=BF16)
    g1 = crf.crf_bwd(lp, *idx, lat0, valid, last, score_dtype=BF16)
    g2 = crf.crf_bwd(lp, *idx, lat0, valid, last, score_dtype=BF16)
    g3 = crf.crf_bwd(lp, *idx, lat1, valid, last, score_dtype=BF16)
    _, s4, none = crf.crf_fwd(lp, *idx, valid, emit_lattice=False,
                              score_dtype=BF16)
    torch.cuda.synchronize()
    assert (crf.crf_fwd.bf16.launches - n[0],
            crf.crf_bwd.bf16.launches - n[1]) == (2, 3)
    assert lat1.dtype == BF16 and g1.dtype == s1.dtype == F32
    assert none is None and torch.equal(s1, s4)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(f1, f0, 1e-4)
    _bf16_states_close(lat1, lat0, 1e-4)
    weight = max(1.0, mfact.max().item())
    diff = (g1 - g0).abs()
    assert diff.max().item() <= 2.0 ** -8 * weight, diff.max().item()
    assert (diff > g_tol * weight).float().mean().item() <= BF16_SHARE
    assert torch.equal(g1, g2)
    assert bool(torch.isfinite(g3).all()) and (g3[:, 1] == 0).all()


def test_crf_bf16_refuses_what_it_does_not_take(dev):
    lp, sidx, midx, mmidx, mfact, valid, last = _crf_inputs(
        20, 4, 12, dev=dev)
    idx = (sidx, midx, mmidx, mfact)
    _, _, lat = crf.crf_fwd(lp, *idx, valid)
    _, _, lat16 = crf.crf_fwd(lp, *idx, valid, score_dtype=BF16)
    with pytest.raises(ValueError, match="lattice"):
        crf.crf_bwd(lp, *idx, lat, valid, last, score_dtype=BF16)
    with pytest.raises(ValueError, match="lattice"):
        crf.crf_bwd(lp, *idx, lat16, valid, last)
    with pytest.raises(ValueError, match="4-byte"):
        odd = torch.empty(lat16.numel() + 1, device=dev, dtype=BF16)[1:]
        crf.crf_bwd(lp, *idx, odd.view(lat16.shape), valid, last,
                    score_dtype=BF16)
    with pytest.raises(ValueError, match="float32"):
        crf.crf_fwd(lp.to(BF16), *idx, valid, score_dtype=BF16)


def test_loss_under_the_switch_on_card(dev, monkeypatch):
    """The training loss's CRF and logZ / T through autograd under the
    switch: the card against the CPU, bf16 instances launched, the
    gradients within a bf16 step of a posterior of each, over T."""
    from taiyaki_tpu_torch.ops import flipflop
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    monkeypatch.delenv("TAIYAKI_TPU_F32_SCORES", raising=False)
    monkeypatch.delenv("TAIYAKI_TPU_NO_SCORE_FUSE", raising=False)
    rng = np.random.default_rng(9)
    T, Bn, L = 200, 8, 60
    lp = rng.normal(size=(T, Bn, 40)).astype(np.float32)
    seqlens = rng.integers(20, L + 1, size=Bn).astype(np.int32)
    from taiyaki_tpu_torch import flipflopfings
    seqs = np.zeros((Bn, L), np.int32)
    for i in range(Bn):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    out = {}
    for device in ("cpu", dev):
        x = torch.from_numpy(lp).to(device).requires_grad_()
        n = (crf.crf_fwd.bf16.launches, logz.logz_fwd.bf16.launches)
        loss = (flipflop.crf_flipflop_loss(
            x, torch.from_numpy(seqs).to(device),
            torch.from_numpy(seqlens).to(device)).sum()
            + flipflop.flipflop_logz(x).sum() / T)
        (g,) = torch.autograd.grad(loss, x)
        out[str(device)] = (loss.item(), g.cpu())
        if device != "cpu":
            torch.cuda.synchronize()
            assert crf.crf_fwd.bf16.launches == n[0] + 1
            assert logz.logz_fwd.bf16.launches > n[1]
    (lc, gc), (ld, gd) = out["cpu"], out[str(dev)]
    assert abs(ld - lc) <= 1e-5 * abs(lc)
    assert (gd - gc).abs().max().item() <= 2 * 2.0 ** -8 / T


# -- the score-stream route's bf16 instances ---------------------------------
#
# Kernels 9-10 with bf16 streams and with f32 streams, each with a bf16
# lattice and bf16 posteriors (the JAX trainer's route under
# TAIYAKI_TPU_NO_SCORE_FUSE=1 and TAIYAKI_TPU_F32_SCORES=1), and logZ's
# mixed instance (f32 scores, a bf16 lattice and posteriors), against
# their twins, which round where the kernels round: the score 1e-3 + 1e-5
# |score|, fwd_final 1e-4 on live states, lattices and posteriors equal as
# bf16 but for at most 1% one bf16 step apart (posteriors on the twin's
# lattice; atol 1e-5, 3e-4 over thousands of steps), d lp within a bf16
# step of a posterior times the largest weight and past the f32 atol at
# most 1% of it, the posteriors and d lp bitwise from run to run.  Widths
# a multiple of 8 for bf16 streams (the band edges' bands, the clusters
# and the device-memory instance), and any for f32 streams.

BF16_STREAM_SHAPES = [(37, 5, 16, 16), (41, 9, 304, 300), (60, 4, 904, 60),
                      (800, 256, 512, 500), (2000, 3, 1904, 1900),
                      (7000, 3, 8192, 6990), (10000, 3, 9000, 8990),
                      (8008, 1, 20000, 8000), (600, 1, 32776, 590)]
MIXED_ONLY_SHAPES = [(300, 6, 509, 280), (73, 5, 65, 65)]


def _check_bf16_streams(case, sdt, atol):
    """Kernel 9, and kernel 10's entries twice each, on `sdt` streams with
    a bf16 lattice, against their twins; each launch counted as its
    instance's."""
    stay32, move32, valid, last, sidx, midx, mmidx, mfact, S = case
    stay, move = stay32.to(sdt), move32.to(sdt)
    idx = (sidx, midx, mmidx, mfact)
    f0, s0, lat0 = crf.crf_fwd_streams_plain(stay, move, valid,
                                             lattice_dtype=BF16)
    p0 = crf.crf_bwd_posteriors_plain(stay, move, lat0, valid, last)
    g0 = crf.crf_grad_streams_plain(stay, move, lat0, valid, last, *idx, S)
    fns = (crf.crf_fwd_streams, crf.crf_bwd_posteriors, crf.crf_grad_streams)
    inst = "bf16" if sdt == BF16 else "mixed"
    n = [getattr(k, inst).launches for k in fns]
    f1, s1, lat1 = crf.crf_fwd_streams(stay, move, valid, lattice_dtype=BF16)
    p1 = crf.crf_bwd_posteriors(stay, move, lat0, valid, last)
    p2 = crf.crf_bwd_posteriors(stay, move, lat0, valid, last)
    g1 = crf.crf_grad_streams(stay, move, lat0, valid, last, *idx, S)
    g2 = crf.crf_grad_streams(stay, move, lat0, valid, last, *idx, S)
    torch.cuda.synchronize()
    assert [getattr(k, inst).launches for k in fns] == [
        n[0] + 1, n[1] + 2, n[2] + 2]
    assert lat1.dtype == BF16 and s1.dtype == f1.dtype == torch.float32
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(f1, f0, 1e-4)
    _bf16_close(lat1, lat0, 1e-4)
    for got, want, again in zip(p1, p0, p2):
        assert got.dtype == BF16
        _bf16_close(got, want, atol)
        assert torch.equal(got, again)
    weight = max(1.0, mfact.max().item())
    diff = (g1 - g0).abs()
    assert diff.max().item() <= 2.0 ** -8 * weight, diff.max().item()
    assert (diff > atol * weight).float().mean().item() <= BF16_SHARE
    assert torch.equal(g1, g2)
    return p1


@pytest.mark.parametrize("sdt", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BF16_STREAM_SHAPES)
def test_crf_stream_bf16_instances_match_twins(dev, shape, sdt):
    T, B, L, n0 = shape
    atol = 1e-5 if T <= 2100 else 3e-4
    p1 = _check_bf16_streams(_stream_case(T, B, L, n0, dev), sdt, atol)
    if n0 <= T + 1:
        mass = (p1[0][:, 0].float().sum() + p1[1][:, 0].float().sum()).item()
        assert abs(mass - T) <= 1e-2 * T


@pytest.mark.parametrize("shape", MIXED_ONLY_SHAPES)
def test_crf_stream_mixed_instance_at_any_width(dev, shape):
    """f32 streams with a bf16 lattice at widths the bf16 streams do not
    take (4-byte copies, odd widths)."""
    T, B, L, n0 = shape
    _check_bf16_streams(_stream_case(T, B, L, n0, dev), torch.float32, 1e-5)


def test_crf_stream_bf16_refuses_what_it_does_not_take(dev):
    """bf16 streams at a width not a multiple of 8, or not 16-byte
    aligned, raise in the wrapper and are refused by the C entry itself
    (no other copy is tried); dtypes of no instance raise."""
    case = _stream_case(20, 3, 24, 10, dev)
    stay, move, valid, last = (t.to(BF16) if t.is_floating_point() else t
                               for t in case[:4])
    with pytest.raises(ValueError, match="multiple of 8"):
        crf.crf_fwd_streams(stay[:, :, :20].contiguous(),
                            move[:, :, :20].contiguous(),
                            valid[:, :20].contiguous())
    odd = torch.empty(stay.numel() + 1, device=dev, dtype=BF16)[1:]
    odd = odd.view(stay.shape).copy_(stay)
    with pytest.raises(ValueError, match="16-byte"):
        crf.crf_fwd_streams(odd, move, valid)
    with pytest.raises(ValueError, match="no instance"):
        crf.crf_fwd_streams(stay, move, valid, lattice_dtype=torch.float32)
    with pytest.raises(ValueError, match="no instance"):
        crf.crf_bwd_posteriors(stay, move, torch.zeros_like(case[0]), valid,
                               last)
    lib = crf.cuda_lib.load("crf", crf._SIGNATURES)
    T, B, L = 20, 3, 20
    out = torch.empty(B, L, device=dev)
    err = lib.tt_crf_fwd_streams(
        stay.data_ptr(), move.data_ptr(), valid.data_ptr(), out.data_ptr(),
        out.data_ptr(), None, None, T, B, L, 1, 1,
        crf.cuda_lib.stream(dev))
    assert err != 0
    err = lib.tt_crf_fwd_streams(
        stay.data_ptr(), move.data_ptr(), valid.data_ptr(), out.data_ptr(),
        out.data_ptr(), None, None, T, B, 24, 1, 0,
        crf.cuda_lib.stream(dev))
    assert err != 0


@pytest.mark.parametrize("shape", [(1, 3, 4), (37, 5, 4), (300, 16, 4),
                                   (1000, 64, 4), (200, 8, 1), (90, 8, 8)])
def test_logz_mixed_instance_matches_twins(dev, shape):
    """logZ's kernels on f32 scores with a bf16 lattice and posteriors
    against their twins (logZ rtol 1e-5 / atol 1e-3, the lattice and the
    posteriors as bf16), counted as the mixed instance's, the posteriors
    bitwise from run to run."""
    T, B, nbase = shape
    rng = np.random.default_rng(T + nbase)
    S = 2 * nbase * (nbase + 1)
    s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(T, B, S))))
                         .astype(np.float32)).to(dev)
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase, lattice_dtype=BF16)
    p0 = logz.logz_posteriors_plain(s, l0, nbase, out_dtype=BF16)
    n = (logz.logz_fwd.mixed.launches, logz.logz_posteriors.mixed.launches,
         logz.logz_fwd.bf16.launches, logz.logz_posteriors.bf16.launches)
    f1, z1, l1 = logz.logz_fwd(s, lattice_dtype=BF16)
    p1 = logz.logz_posteriors(s, l0, out_dtype=BF16)
    p2 = logz.logz_posteriors(s, l0, out_dtype=BF16)
    torch.cuda.synchronize()
    assert (logz.logz_fwd.mixed.launches - n[0],
            logz.logz_posteriors.mixed.launches - n[1]) == (
        logz.forward_kernels(T, B, nbase),
        2 * logz.posterior_kernels(T, B, nbase))
    assert (logz.logz_fwd.bf16.launches,
            logz.logz_posteriors.bf16.launches) == n[2:]
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)

    def states(t):
        return t.float().clamp(min=-1e30).to(BF16)
    _bf16_close(states(l1), states(l0), 1e-4)
    assert p1.dtype == BF16
    _bf16_close(p1, p0, 1e-5)
    assert torch.equal(p1, p2)
    with pytest.raises(ValueError, match="no instance"):
        logz.logz_posteriors(s, l0)


@pytest.mark.parametrize("env", ["TAIYAKI_TPU_NO_SCORE_FUSE",
                                 "TAIYAKI_TPU_F32_SCORES"])
def test_stream_route_under_the_switch_on_card(dev, env, monkeypatch):
    """The cat_mod loss and logZ / T through autograd, and make_trans,
    under the switch with each score switch: the card against the CPU,
    the streams route's and logZ's instances of the row launched (bf16
    streams, or the mixed ones), the loss 1e-5 relative, the gradient
    within a bf16 step of a posterior times the largest weight, over T;
    make_trans within a bf16 step."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import decode, flipflop
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    for name in ("TAIYAKI_TPU_NO_SCORE_FUSE", "TAIYAKI_TPU_F32_SCORES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(env, "1")
    inst = "mixed" if env == "TAIYAKI_TPU_F32_SCORES" else "bf16"
    rng = np.random.default_rng(13)
    T, B, L = 200, 8, 61
    offsets = np.array([0, 2, 3, 5, 6], np.int32)
    x = rng.normal(size=(T, B, 40 + 6)).astype(np.float32)
    seqlens = rng.integers(20, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    cats = np.zeros((B, L), np.int32)
    for i in range(B):
        bases = rng.integers(0, 4, size=seqlens[i])
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(bases)
        cats[i, :seqlens[i]] = np.where(np.isin(bases, [0, 2]),
                                        rng.integers(0, 2, seqlens[i]), 0)
    weights = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    counted = (crf.crf_fwd_streams, crf.crf_grad_streams, logz.logz_fwd,
               logz.logz_posteriors)
    out = {}
    for device in ("cpu", dev):
        tx = torch.from_numpy(x).to(device).requires_grad_()
        n = [getattr(k, inst).launches for k in counted]
        loss = (flipflop.cat_mod_flipflop_loss(
            tx, *(torch.from_numpy(a).to(device)
                  for a in (seqs, seqlens, cats)), offsets, weights).sum()
            + flipflop.flipflop_logz(tx[:, :, :40]).sum() / T)
        (g,) = torch.autograd.grad(loss, tx)
        trans = decode.flipflop_make_trans(tx.detach()[:, :, :40])
        out[str(device)] = (loss.item(), g.cpu(), trans.cpu())
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [getattr(k, inst).launches - c for k, c in zip(counted, n)]
            assert ran[0] == 1 and ran[1] == 1 and ran[2] > 0 and ran[3] > 0
    (lc, gc, tc), (ld, gd, td) = out["cpu"], out[str(dev)]
    assert abs(ld - lc) <= 1e-5 * abs(lc)
    assert (gd - gc).abs().max().item() <= 2 * 2.0 ** -8 * 2.0 / T
    assert td.dtype == torch.float32
    assert (td - tc).abs().max().item() <= 2.0 ** -8


# -- the scans' bf16 instances -----------------------------------------------
#
# Kernels 14-17 under the JAX scans' mixed precision (ops/rnn.py
# `scan_streams`): the gate stream bf16 (or f32 under
# TAIYAKI_TPU_F32_GATES), h f32, the residuals (c and pre, gh) bf16, dh and
# the stored gradients (dpre, dgx and dgh) bf16 (or f32 under
# TAIYAKI_TPU_F32_GRADS), on the plan's instance and the forced L2 one,
# against their twins: h 1e-4, d_x 1e-4 relative, f32 gradients 1e-4
# relative, bf16 outputs equal as bf16 but for at most 1% one step apart.
# H=96 is train_abinitio's width; at H=512 the forwards' plans (and the
# LSTM's chain) take the L2 instance.

BF16_SCAN_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (50, 24, 64, 256),
                    (40, 16, 96, 96), (120, 37, 384, 384), (20, 16, 64, 512)]
F32 = torch.float32
# (gx, dh and the stored gradients): the default, F32_GATES, F32_GRADS,
# both
SCAN_DTYPES = [(BF16, BF16), (F32, BF16), (BF16, F32), (F32, F32)]


def _scan_fns(cell):
    """(forward, its twin, chain, its twin) of `cell`'s scan kernels."""
    mod = lstm if cell == "lstm" else gru
    return tuple(getattr(mod, "{}_scan_{}{}".format(cell, way, k))
                 for way in ("fwd", "bwd") for k in ("", "_plain"))


def _scan_bf16_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == BF16:
        _bf16_close(got, want,
                    1e-4 * max(1.0, want.float().abs().max().item()))
    else:
        assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_SCAN_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_bf16_fwd_matches_twin(dev, cell, shape, reverse):
    """Kernels 14 and 16's bf16 instances, gates bf16 or f32, with and
    without their residuals: h f32, c, pre and gh bf16; gates_x left as
    it was."""
    fwd, plain = _scan_fns(cell)[:2]
    gx, sW = _scan_case(cell, shape, reverse, dev)[:2]
    for gdt in (BF16, F32):
        g = gx.to(gdt)
        kept = g.clone()
        for res in (False, True):
            want = _as_tuple(plain(g, sW, reverse, res, BF16))
            for inst in (None, "l2"):
                n, nb = _counts(fwd), fwd.bf16.launches
                got = _as_tuple(fwd(g, sW, reverse=reverse, residuals=res,
                                    instance=inst, res_dtype=BF16))
                torch.cuda.synchronize()
                assert fwd.bf16.launches == nb + 1
                ran = {k for k, v in _counts(fwd).items() if v != n[k]}
                assert len(ran) == 1 and (inst is None or ran == {inst})
                assert len(got) == len(want) == (
                    1 if not res else 3 if cell == "lstm" else 2)
                assert got[0].dtype == F32
                assert (got[0] - want[0]).abs().max().item() < 1e-4
                for o, w in zip(got[1:], want[1:]):
                    assert o.dtype == BF16
                    _bf16_close(o, w, 1e-4)
        assert torch.equal(g, kept)


def _scan_bwd_args(cell, shape, reverse, dev, gdt, dhdt):
    """The chain's arguments on the bf16 forward twin's residuals, and
    iW."""
    gx, sW, iW, dh = _scan_case(cell, shape, reverse, dev)
    g = gx.to(gdt)
    if cell == "lstm":
        _, c, pre = lstm.lstm_scan_fwd_plain(g, sW, reverse, True, BF16)
        return (dh.to(dhdt), pre, c, lstm.prev_state(c, reverse), sW), iW
    h, gh = gru.gru_scan_fwd_plain(g, sW, reverse, True, BF16)
    return (dh.to(dhdt), g, gh, lstm.prev_state(h, reverse), sW), iW


@pytest.mark.parametrize("with_iw", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BF16_SCAN_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_bf16_bwd_matches_twin(dev, cell, shape, reverse, with_iw):
    """Kernels 15 and 17's bf16 instances in each case of SCAN_DTYPES:
    the gradients stored in dh's dtype; d_x f32, within 1e-4 of the
    product of the kernel's own stored gradient (dpre or dgx) and, where
    that is bf16, within one bf16 step (2^-8) of the largest of the
    twin's (a stored value may round the other way); their inputs left
    as they were."""
    fn, plain = _scan_fns(cell)[2:]
    for gdt, gd in SCAN_DTYPES:
        args, iW = _scan_bwd_args(cell, shape, reverse, dev, gdt, gd)
        iw = iW if with_iw else None
        kept = [a.clone() for a in args]
        want = _as_tuple(plain(*args, reverse=reverse, iW=iw))
        for inst in (None, "l2"):
            n, nb = _counts(fn), _bf16_counts(fn)
            got = _as_tuple(fn(*args, reverse=reverse, iW=iw,
                               instance=inst))
            torch.cuda.synchronize()
            ran = {k for k, v in _bf16_counts(fn).items() if v != nb[k]}
            assert _counts(fn) != n and len(ran) == 1 \
                and (inst is None or ran == {inst})
            assert len(got) == len(want)
            grads = len(got) - with_iw
            for g, w in zip(got[:grads], want[:grads]):
                assert g.dtype == gd
                _scan_bf16_close(g, w)
            if with_iw:
                assert got[-1].dtype == F32
                assert _rel_err(got[-1],
                                torch.matmul(got[0].float(), iW)) < 1e-4
                assert _rel_err(got[-1], want[-1]) < (
                    1e-4 if gd == F32 else 2.0 ** -8)
        assert all(torch.equal(a, k) for a, k in zip(args, kept))


def test_scan_bf16_instances_on_both_chain_instances(dev):
    """At the mLstm and mGru width the plans take the cluster instances; at
    H=512 the forwards' plans and the LSTM's chain the L2 ones (the GRU's
    backward slice still fits a cluster of 16): the bf16 launches of the
    four scans land on the plans' instances."""
    for cell, G in (("lstm", 4), ("gru", 3)):
        fwd, _, bwd, _ = _scan_fns(cell)
        for shape in ((50, 24, 64, 256), (20, 16, 64, 512)):
            fi = _plan(G, shape[3], shape[1]).instance
            bi = _bwd_plan(G, shape[3], shape[1]).instance
            assert fi == ("cluster" if shape[3] == 256 else "l2")
            assert bi == ("l2" if (cell, shape[3]) == ("lstm", 512)
                          else "cluster")
            args, _ = _scan_bwd_args(cell, shape, False, dev, BF16, BF16)
            gx = _scan_case(cell, shape, False, dev)[0].to(BF16)
            nb = _bf16_counts(fwd)
            fwd(gx, args[-1], residuals=True, res_dtype=BF16)
            assert _bf16_counts(fwd) == dict(nb, **{fi: nb[fi] + 1})
            nb = _bf16_counts(bwd)
            bwd(*args)
            assert _bf16_counts(bwd) == dict(nb, **{bi: nb[bi] + 1})


@pytest.mark.parametrize("sub", ["default", "F32_GATES", "F32_GRADS"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scans_bf16_streams_on_card(dev, cell, reverse, sub, monkeypatch):
    """`rnn.lstm_scan` / `gru_scan` under the switch on the card against
    the same on the CPU (the twins): h f32 within 1e-4, d gates_x and d_sW
    f32 within one bf16 step of the largest (a stored gradient may round
    the other way); the card launched the bf16 instances, the f32 ones
    not, and d_sW of bf16 gradients took the atb GEMM."""
    monkeypatch.setenv("TAIYAKI_TPU_BF16_STREAMS", "1")
    if sub != "default":
        monkeypatch.setenv("TAIYAKI_TPU_" + sub, "1")
    scan = rnn.lstm_scan if cell == "lstm" else rnn.gru_scan
    fwd, _, bwd, _ = _scan_fns(cell)
    gx, sW, _, dh = _scan_case(cell, (60, 24, 32, 64), reverse, dev)
    out = {}
    for device in ("cpu", dev):
        leaves = [a.to(device).clone().requires_grad_() for a in (gx, sW)]
        n = [fn.launches for fn in (fwd, bwd, gemm.atb_gemm)]
        nb = [fn.bf16.launches for fn in (fwd, bwd)]
        h = scan(*leaves, reverse=reverse)
        grads = torch.autograd.grad(h, leaves, dh.to(device))
        assert h.dtype == F32 and [g.dtype for g in grads] == [F32] * 2
        out[str(device)] = [h.detach().cpu()] + [g.cpu() for g in grads]
        if device != "cpu":
            torch.cuda.synchronize()
            assert [fn.bf16.launches - k for fn, k in
                    zip((fwd, bwd), nb)] == [1, 1]
            assert [fn.launches - k for fn, k in
                    zip((fwd, bwd), n)] == [1, 1]
            assert gemm.atb_gemm.launches - n[2] == (
                0 if sub == "F32_GRADS" else 1)
    cpu, card = out["cpu"], out[str(dev)]
    assert (card[0] - cpu[0]).abs().max().item() < 1e-4
    for g, w in zip(card[1:], cpu[1:]):
        assert _rel_err(g, w) < 2.0 ** -8


# -- the bf16 chains' word-major ring -----------------------------------------
#
# The bf16 instances of the chains (kernels 4, 11, 12, 15; 8, 13, 17) on
# the cluster instance fill their ring [R][BT][U] by cp.async of whole runs
# of U units (csrc/rec_cluster.cuh, the bf16 chains' ring): here at each
# width a bf16 word's copies take (16 bytes: H=256, C=8; 8: H=96, C=8; 4:
# H=100, C=2), both directions, with a tile past the batch (B one row
# past a tile), in each case of BF16_BWD_DTYPES (dh f32 as under
# TAIYAKI_TPU_F32_GRADS, the recompute's f32 pre and gates, the GRU's
# recompute in place over them) and of SCAN_DTYPES, against their twins
# on the terms of the bf16 tests above; then a view whose offset cuts the
# width, copied by the wrapper, or refused by the C entry when it is
# passed as it is.

RING_WIDTHS = [(16, 256, 8), (8, 96, 8), (4, 100, 2)]


def _ring_plan(gates, H, C):
    """A cluster plan of C ranks for H that the bf16 instances take, with
    a tile of more than one row."""
    for c, BT, RB, KL in rnn_plan.bwd_cluster_plans(gates, H, True):
        if c == C and BT > 1:
            return rnn_plan.Plan("cluster", C, BT, RB, KL,
                                 rnn_plan.bwd_smem(gates, H, C, BT))
    raise AssertionError("no plan of {} ranks for H={}".format(C, H))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("W, H, C", RING_WIDTHS)
def test_bf16_ring_widths_match_twins(dev, W, H, C, reverse, monkeypatch):
    """Every bf16 chain on a cluster plan whose bf16 words copy W bytes at
    a time, launched on the cluster instance (the GRU recompute with every
    stream f32 on its f32 instance), against its twin."""
    assert rnn_plan.ring_width(2, H, -(-H // C)) == W
    for cell, G in (("lstm", 4), ("gru", 3)):
        plan = _ring_plan(G, H, C)
        monkeypatch.setattr(rnn_plan, "bwd_plan",
                            lambda *a, _p=plan, **k: _p)
        shape = (9, plan.BT + 1, 24, H)
        rows = _bf16_bwd_rows if cell == "lstm" else _bf16_gru_bwd_rows
        for dts in BF16_BWD_DTYPES:
            for fn, plain, args in rows(shape, reverse, dev, *dts):
                nb = _bf16_counts(fn)
                got = fn(*args, reverse=reverse)
                torch.cuda.synchronize()
                bf16 = (fn is not gru.gru_bwd_recompute
                        or BF16 in dts)
                assert _bf16_counts(fn) == (
                    dict(nb, cluster=nb["cluster"] + 1) if bf16 else nb)
                _check_bf16_bwd(got, plain(*args, reverse=reverse))
        fn, plain = _scan_fns(cell)[2:]
        for gdt, gd in SCAN_DTYPES:
            args, iW = _scan_bwd_args(cell, shape, reverse, dev, gdt, gd)
            nb = _bf16_counts(fn)
            got = _as_tuple(fn(*args, reverse=reverse, iW=iW))
            torch.cuda.synchronize()
            assert _bf16_counts(fn) == dict(nb, cluster=nb["cluster"] + 1)
            want = _as_tuple(plain(*args, reverse=reverse, iW=iW))
            for g, w in zip(got[:-1], want[:-1]):
                assert g.dtype == gd
                _scan_bf16_close(g, w)
            assert _rel_err(got[-1], torch.matmul(got[0].float(), iW)) < 1e-4


def _view_at(t, k):
    """t's values in a view k elements into a buffer of its own."""
    buf = torch.empty(t.numel() + k, device=t.device, dtype=t.dtype)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_ring_takes_a_misaligned_view(dev, cell, monkeypatch):
    """At the training plan (C=8, 16-byte copies) a bf16 dh 2 bytes off
    and 8 bytes off, and an f32 one 4 bytes off: the wrapper's copy
    (`rnn_plan.ring_ready`) gives the aligned call's outputs bit for bit;
    passed to the C entry as they are, each is refused (misaligned
    address) before any launch."""
    shape = (9, 19, 24, 256)
    rows = _bf16_bwd_rows if cell == "lstm" else _bf16_gru_bwd_rows
    for dhdt, ks in ((BF16, (1, 4)), (torch.float32, (1,))):
        fn, _, args = rows(shape, False, dev, BF16, BF16, dhdt)[1]
        want = fn(*args)
        for patched in (False, True):
            if patched:
                monkeypatch.setattr(rnn_plan, "ring_ready",
                                    lambda plan, H, bf16, *t: list(t))
            for k in ks:
                dh = _view_at(args[0], k)
                if patched:
                    with pytest.raises(RuntimeError,
                                       match="misaligned address"):
                        fn(dh, *args[1:])
                    continue
                got = fn(dh, *args[1:])
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
            monkeypatch.undo()
