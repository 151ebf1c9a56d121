"""The CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA card with nvcc (sm_90a) and skip elsewhere.  The file
imports no JAX, so it runs on a machine with only PyTorch and CUDA:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: LSTM h (and c, acts, tanh c) atol 1e-4 (f32 sums in another
order, carried through the recurrence); LSTM backward 1e-4 relative to
the largest value of each output (sums of up to T*B products in another
order; the same for the backwards from stored pre and rebuilding pre);
logZ rtol 1e-5 / atol 1e-3 over T up to 1000; lattices atol 1e-4;
posteriors atol 1e-5; the CRF score 1e-3 + 1e-5 |score| and its gradient
atol 1e-5 (posteriors, each in [0, 1]; 3e-4 over lattices of thousands of
steps, see CRF_SHAPES), 1e-6 from run to run (the order
of the shared-memory atomic adds); GRU h atol 1e-4 and its backward 1e-4
relative, as the LSTM's (gh and gx of the forward atol 1e-4, as h).
A retained graph gives bitwise the same gradients twice.
"""

import math

import numpy as np
import pytest
import torch

from taiyaki_tpu_torch.ops import crf, gru, lstm, logz, rnn

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
                                   (200, 128, 256, 256)])
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


@pytest.mark.parametrize("shape", [(37, 13, 4), (50, 5, 2), (50, 5, 3),
                                   (1000, 128, 4)])
def test_logz_kernels_match_twins(dev, shape):
    T, B, nbase = shape
    s = _scores(T, B, nbase).to(dev)
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase)
    p0 = logz.logz_posteriors_plain(s, l0, nbase)
    f1, z1, l1 = logz.logz_fwd(s)
    p1 = logz.logz_posteriors(s, l1)
    _, z2, none = logz.logz_fwd(s, emit_lattice=False)
    torch.cuda.synchronize()
    assert none is None
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-3)
    assert torch.equal(z1, z2)
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-4)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)
    torch.testing.assert_close(p1, p0, rtol=0, atol=1e-5)


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


LSTM_SHAPES = [(37, 13, 7, 16), (5, 3, 300, 40), (800, 256, 256, 256)]


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


def _crf_inputs(T, B, L, seed=2, nmod=0, dev="cpu"):
    """Scores, lattice index vectors of random sequences with ragged
    lengths (row 1 empty, row 2 longer than T allows: no path)."""
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
        mf = torch.from_numpy(rng.uniform(0.1, 1.0, size=(B, L - 1))
                              .astype(np.float32))
    idx = flipflop._lattice_inputs(stay, move, torch.from_numpy(seqlens), S,
                                   mm, mf)
    return [lp.to(dev)] + [t.to(dev) for t in idx]


def _lattice_close(got, want, atol):
    live = want > crf.NEG / 2
    assert (got[~live] <= crf.NEG / 2).all()
    return (got[live] - want[live]).abs().max().item() <= atol


# (T, B, L, mod columns, gradient atol).  Over the long lattices (T of
# 4000 and 7000 steps) the log-space forward and backward lattices and the
# score of kernel and twin each drift apart by up to their 1e-4
# tolerance, so a posterior p = exp(fwd + bwd - score) moves by at most
# 3e-4 p, and a gradient entry sums posteriors of total at most 1: the
# gradient is held to 3e-4 there.
CRF_SHAPES = [(37, 5, 12, 0, 1e-5), (41, 9, 300, 0, 1e-5),
              (30, 6, 20, 3, 1e-5), (800, 256, 512, 0, 1e-5),
              (4000, 6, 3712, 0, 3e-4), (7000, 3, 8192, 0, 3e-4)]


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
    torch.cuda.synchronize()
    assert (crf.crf_fwd.launches, crf.crf_bwd.launches) == (nf + 2, nb + 2)
    assert none is None and torch.equal(s1, s3)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-3)
    assert _lattice_close(lat1, lat0, 1e-4)
    assert _lattice_close(f1, f0, 1e-4)
    assert torch.isfinite(g1).all()
    assert (g1[:, 1] == 0).all()            # the empty row
    torch.testing.assert_close(g1, g0, rtol=0, atol=g_tol)
    torch.testing.assert_close(g1, g2, rtol=0, atol=1e-6)


def _gru_inputs(T, B, D, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (rng.normal(size=(3 * H, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.5 * rng.normal(size=3 * H)).astype(np.float32)
    sW = (rng.normal(size=(3 * H, H)) / np.sqrt(H)).astype(np.float32)
    dh = rng.normal(size=(T, B, H)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, iW, b, sW, dh)]


GRU_SHAPES = [(37, 13, 7, 16), (19, 24, 12, 17), (5, 3, 300, 40),
              (300, 64, 96, 96), (200, 128, 256, 256)]


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
