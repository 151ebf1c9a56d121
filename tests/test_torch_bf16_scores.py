"""The bf16 score streams of the CRF's fused route and of logZ
(TAIYAKI_TPU_BF16_STREAMS=1, ops/flipflop.py `score_dtype`) on the CPU,
against the JAX package's mixed precision, which it runs on the CPU under
TAIYAKI_TPU_PALLAS_INTERPRET=1 (B a multiple of 8), on the same seeded
numpy inputs:

(a) the bf16 twins of kernels 2, 3, 5 and 6 against
    `pallas_logz.logz_forward(residual_dtype=bf16)`,
    `logz_backward_posteriors(out_dtype=bf16)`,
    `pallas_crf.crf_forward_fused` and `crf_backward_fused` in interpret
    mode, each fed the same bf16 scores (logZ) or f32 lp (the CRF) and
    the same bf16 lattice (the backwards), canonical and cat_mod index
    sets: bf16 outputs (lattices, posteriors) equal as bf16 but for at
    most 1% of them one bf16 step apart (`bf16_close`: the f32 values
    before the rounding differ by the order of their sums); f32 outputs
    logZ 1e-3 + 1e-5 |logZ| (tests/test_torch_logz_forward.py's), the
    CRF score 1e-5 relative and d lp 1e-6 (both round their scores and
    posteriors at the same points; only f32 sums differ); and the
    segmented mirrors of the logZ kernels against the twins on the same
    terms;
(b) `flipflop_logz`, `crf_flipflop_loss` and `cat_mod_flipflop_loss`
    and their gradients under the switch against the JAX package's mixed
    route: each within half of the JAX route's own distance from its f32
    route (the port's distance from the JAX mixed values; the port's own
    distance from its f32 values at most twice the JAX route's);
(c) with the switch unset every call is the f32 one: no dtype argument
    reaches a kernel wrapper, the loss and logZ and their gradients are
    bit for bit the f32 twins', the fused forward's lattice bit for bit
    the streams twin's (kernel 9's, which this slice leaves alone);
(d) under the switch with TAIYAKI_TPU_F32_SCORES=1 the CRF takes the
    streams route on f32 streams and logZ reads f32 scores, both with
    bf16 lattices and posteriors; with TAIYAKI_TPU_NO_SCORE_FUSE=1 the
    streams, logZ's scores, lattices and posteriors are all bf16 (the
    streams route's own tests: tests/test_torch_bf16_score_streams.py);
    validation (no grad) rounds the scores and emits no lattice; the
    wrappers refuse dtypes of no instance;
(e) one training step of a size-16 mLstm_flipflop (B=8, chunks of 500
    samples) under the switch against the port's f32 step (loss 5e-3
    relative, each gradient 2e-2 of its largest), the four bf16
    instances counted by dtype;
(f) `cli.train_flipflop` on the CPU under the switch (2 iterations,
    size 16): bf16 CRF and logZ calls in training and validation, its
    batch.log losses within 5e-3 of the f32 run's (shared_run).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_crf, pallas_logz
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
from taiyaki_tpu_torch.models import mLstm_flipflop as tmodel
from taiyaki_tpu_torch.ops import crf as tcrf
from taiyaki_tpu_torch.ops import flipflop as tff
from taiyaki_tpu_torch.ops import logz as tlogz
from taiyaki_tpu.models import mLstm_flipflop as jmodel
from test_torch_all_layers import _batch
from test_torch_bf16_streams import BF16, F32, SUB_SWITCHES, SWITCH, \
    _to_jax, _to_torch, bf16_close
from test_torch_cli import one_torch_thread, shared_run, \
    subprocess_env  # noqa: F401 (autouse)
from test_torch_crf import _case

SCORE_SWITCHES = ("TAIYAKI_TPU_NO_SCORE_FUSE",)


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    """Every test starts with the switches unset."""
    for k in (SWITCH,) + SUB_SWITCHES + SCORE_SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _scores(T, B, nbase, seed):
    rng = np.random.default_rng(seed)
    S = 2 * nbase * (nbase + 1)
    return (5.0 * np.tanh(rng.normal(size=(T, B, S)))).astype(np.float32)


def _close_logz(got, want):
    tol = 1e-3 + 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _states(t):
    """A bf16 lattice with -inf (the port's impossible states) as the TPU
    kernel's -1e30."""
    return t.float().clamp(min=-1e30).to(BF16)


# -- (a) the bf16 twins against the TPU kernels in interpret mode ------------

LOGZ_CASES = [(4, 37, 8), (2, 50, 8), (4, 100, 16), (1, 20, 8)]


def _jax_logz(s16, nbase):
    """The TPU kernels' (logZ, bf16 lattice, bf16 posteriors) in interpret
    mode on bf16 scores, sliced back from their padding."""
    T, _, S = s16.shape
    bt = 8
    sp = jff._logz_pad_scores(_to_jax(s16), bt, dtype=jnp.bfloat16)
    _, z, lat = pallas_logz.logz_forward(sp, nbase, block_t=bt,
                                         interpret=True,
                                         residual_dtype=jnp.bfloat16)
    post = pallas_logz.logz_backward_posteriors(
        sp, lat, nbase, block_t=bt, interpret=True, out_dtype=jnp.bfloat16)
    nff = 2 * nbase
    return (np.asarray(z), _to_torch(lat[:T, :, :nff]),
            _to_torch(post[:T, :, :S]))


@pytest.mark.parametrize("nbase,T,B", LOGZ_CASES)
def test_logz_forward_twin_matches_pallas_kernel(nbase, T, B):
    s16 = torch.from_numpy(_scores(T, B, nbase, seed=T + nbase)).to(BF16)
    zj, latj, _ = _jax_logz(s16, nbase)
    f, z, lat = tlogz.logz_fwd_plain(s16, nbase)
    assert f.dtype == z.dtype == F32 and lat.dtype == BF16
    _close_logz(z.numpy(), zj)
    bf16_close(_states(lat), latj, atol=0.0)
    # the kernels' segmented mirror, on the same terms
    f1, z1, lat1 = tlogz.logz_fwd_segmented(s16, nbase, 7)
    assert lat1.dtype == BF16
    _close_logz(z1.numpy(), z.numpy())
    bf16_close(_states(lat1), _states(lat), atol=0.0)
    torch.testing.assert_close(f1, f, rtol=0, atol=1e-4)


@pytest.mark.parametrize("nbase,T,B", LOGZ_CASES)
def test_logz_posteriors_twin_matches_pallas_kernel(nbase, T, B):
    """On the TPU kernel's own bf16 lattice."""
    s16 = torch.from_numpy(_scores(T, B, nbase, seed=T + nbase)).to(BF16)
    _, latj, postj = _jax_logz(s16, nbase)
    lat = latj.float().masked_fill(latj.float() < -1e29,
                                   -math.inf).to(BF16)
    post = tlogz.logz_posteriors_plain(s16, lat, nbase)
    assert post.dtype == BF16
    bf16_close(post, postj, atol=0.0)
    seg = tlogz.logz_posteriors_segmented(s16, lat, nbase, 7)
    assert seg.dtype == BF16
    bf16_close(seg, post, atol=0.0)


def _jax_crf(lp, seqs, seqlens, mm, mf, lattice=None):
    """The fused TPU kernels' (score, bf16 lattice, d lp) in interpret
    mode, index vectors lane-padded as ops/flipflop.py pads them; the
    backward on `lattice` where given."""
    T, bt = lp.shape[0], 4
    L = seqs.shape[1]
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    valid = jnp.arange(L)[None, :] < jnp.asarray(seqlens)[:, None]
    setup = jff._fused_setup(
        jnp.asarray(lp), stay, move, None if mm is None else jnp.asarray(mm),
        None if mf is None else jnp.asarray(mf), valid)
    _, bb, _, idxs, _, valid_p = setup
    lp_p = jff._pad_axis(jnp.asarray(lp), 0, bt, 0.0)
    fwd, score, lat = pallas_crf.crf_forward_fused(
        lp_p, *idxs, valid_p, block_b=bb, block_t=bt, true_len=T,
        interpret=True, residual_dtype=jnp.bfloat16)
    last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    score = score + jnp.take_along_axis(fwd[:, :L], last[:, None],
                                        axis=1)[:, 0]
    if lattice is not None:
        lat = jff._pad_axis(jff._pad_axis(_to_jax(lattice), 2, 128, -1e30),
                            0, bt, 0.0)
    grad = pallas_crf.crf_backward_fused(
        lp_p, *idxs, lat, valid_p, last[:, None].astype(jnp.int32),
        block_b=bb, block_t=bt, true_len=T, interpret=True)[:T]
    return (np.asarray(score), _to_torch(lat[:T, :, :L]),
            torch.from_numpy(np.asarray(grad)))


def _port_inputs(lp, seqs, seqlens, mm, mf):
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    return tff._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), lp.shape[2],
        None if mm is None else torch.from_numpy(mm),
        None if mf is None else torch.from_numpy(mf))


CRF_CASES = [(0, 10), (3, 11), (0, 12), (3, 13)]


@pytest.mark.parametrize("nmod,seed", CRF_CASES)
def test_crf_forward_twin_matches_fused_pallas_kernel(nmod, seed):
    lp, seqs, seqlens, mm, mf = _case(T=12, nmod=nmod, seed=seed)
    want_s, want_lat, _ = _jax_crf(lp, seqs, seqlens, mm, mf)
    sidx, midx, mmidx, mfact, valid, last = _port_inputs(lp, seqs, seqlens,
                                                         mm, mf)
    fwd, score, lat = tcrf.crf_fwd_plain(torch.from_numpy(lp), sidx, midx,
                                         mmidx, mfact, valid,
                                         score_dtype=BF16)
    assert lat.dtype == BF16 and score.dtype == F32
    score = score + fwd.gather(1, last.long()[:, None])[:, 0]
    # the empty row and the row with no path sum NEG
    has_path = np.array([b not in (1, 2) for b in range(len(seqlens))])
    np.testing.assert_allclose(score.numpy()[has_path], want_s[has_path],
                               rtol=1e-5)
    bf16_close(lat, want_lat, atol=0.0)


@pytest.mark.parametrize("nmod,seed", CRF_CASES)
def test_crf_backward_twin_matches_fused_pallas_kernel(nmod, seed):
    """On the port twin's bf16 lattice, fed to both."""
    lp, seqs, seqlens, mm, mf = _case(T=12, nmod=nmod, seed=seed)
    sidx, midx, mmidx, mfact, valid, last = _port_inputs(lp, seqs, seqlens,
                                                         mm, mf)
    _, _, lat = tcrf.crf_fwd_plain(torch.from_numpy(lp), sidx, midx, mmidx,
                                   mfact, valid, score_dtype=BF16)
    _, _, want = _jax_crf(lp, seqs, seqlens, mm, mf, lattice=lat)
    grad = tcrf.crf_bwd_plain(torch.from_numpy(lp), sidx, midx, mmidx,
                              mfact, lat, valid, last, score_dtype=BF16)
    assert grad.dtype == F32
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-6)
    # every column a sum of bf16 posteriors (weights 1 or bf16(fact))
    assert not grad[:, 1].any() and not grad[:, 2].any()


# -- (b) the loss and logZ under the switch against the JAX mixed route -----

def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())


def _jax_loss(fn, args, monkeypatch, interpret):
    """(value, gradient) of sum(g * fn(x, *rest)) in the JAX package."""
    if interpret:
        monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    x, rest, g = args
    value, vjp = jax.vjp(lambda y: fn(y, *rest), jnp.asarray(x))
    grad = vjp(jnp.asarray(g))[0]
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET", raising=False)
    return np.asarray(value), np.asarray(grad)


def _port_loss(fn, args, monkeypatch, switch):
    if switch:
        monkeypatch.setenv(SWITCH, "1")
    x, rest, g = args
    tx = torch.from_numpy(x).requires_grad_()
    value = fn(tx, *rest)
    (grad,) = torch.autograd.grad(value, tx, torch.from_numpy(g))
    monkeypatch.delenv(SWITCH, raising=False)
    return value.detach().numpy(), grad.numpy()


def _loss_case(kind, seed):
    """JAX function, port function, (x, the JAX function's other
    arguments, g), and the port's other arguments."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=8).astype(np.float32)
    if kind == "logz":
        x = _scores(60, 8, 4, seed)
        return jff.flipflop_logz, tff.flipflop_logz, (x, (), g), ()
    lp, seqs, seqlens, _, _ = _case(T=40, B=8, L=14, seed=seed)
    seqlens[2] = 9          # a row with a path
    tseqs, tlens = torch.from_numpy(seqs), torch.from_numpy(seqlens)
    if kind == "crf":
        return (jff.crf_flipflop_loss, tff.crf_flipflop_loss,
                (lp, (seqs, seqlens, 1.5), g), (tseqs, tlens, 1.5))
    # cat_mod: one mod category beside each canonical base's, 48 columns
    offsets = np.array([0, 2, 4, 6, 8])
    cats = rng.integers(0, 2, size=seqs.shape).astype(np.int32)
    weights = np.array([1.0, 0.7] * 4, np.float32)
    lp = np.concatenate([lp, rng.normal(size=lp.shape[:2] + (8,)).astype(
        np.float32)], axis=2)
    return (jff.cat_mod_flipflop_loss, tff.cat_mod_flipflop_loss,
            (lp, (seqs, seqlens, cats, offsets, weights, 1.5), g),
            (tseqs, tlens, torch.from_numpy(cats), offsets, weights, 1.5))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["logz", "crf", "cat_mod"])
def test_loss_within_the_jax_mixed_routes_distance(kind, seed, monkeypatch):
    jfn, tfn, args, targs = _loss_case(kind, seed)
    j32 = _jax_loss(jfn, args, monkeypatch, False)
    j16 = _jax_loss(jfn, args, monkeypatch, True)
    targs = (args[0], targs, args[2])
    t32 = _port_loss(tfn, targs, monkeypatch, False)
    t16 = _port_loss(tfn, targs, monkeypatch, True)
    for i, what in enumerate(("value", "gradient")):
        route = _dist(j16[i], j32[i])
        assert route > 0, what
        assert _dist(t16[i], j16[i]) <= 0.5 * route, (
            what, _dist(t16[i], j16[i]), route)
        assert _dist(t16[i], t32[i]) <= 2 * route, (
            what, _dist(t16[i], t32[i]), route)
        assert _dist(t32[i], j32[i]) <= 1e-4 * max(
            np.abs(j32[i]).max(), 1.0), what


# -- (c) the switch unset: the f32 calls as they were ------------------------

def _recording(monkeypatch, calls):
    """Record each kernel wrapper's keyword arguments and the dtypes of
    its tensors, in ops.flipflop's namespace."""
    def wrap(mod, name):
        real = getattr(mod, name)

        def spy(*args, **kw):
            calls.append((name, tuple(a.dtype for a in args
                                      if isinstance(a, torch.Tensor)
                                      and a.is_floating_point()),
                          dict(kw)))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    for name in ("crf_fwd", "crf_bwd", "crf_fwd_streams",
                 "crf_grad_streams"):
        wrap(tcrf, name)
    for name in ("logz_fwd", "logz_posteriors"):
        wrap(tff, name)


def _loss_and_grads(lp, seqs, seqlens, scores):
    tlp = torch.from_numpy(lp).requires_grad_()
    ts = torch.from_numpy(scores).requires_grad_()
    loss = (tff.crf_flipflop_loss(tlp, torch.from_numpy(seqs),
                                  torch.from_numpy(seqlens)).sum()
            + tff.flipflop_logz(ts).sum())
    return (loss.detach(),) + torch.autograd.grad(loss, (tlp, ts))


def test_switch_unset_is_the_f32_call(monkeypatch):
    lp, seqs, seqlens, _, _ = _case(T=20, B=8, seed=20)
    seqlens[2] = 9
    scores = _scores(20, 8, 4, seed=21)
    calls = []
    _recording(monkeypatch, calls)
    got = _loss_and_grads(lp, seqs, seqlens, scores)
    # no dtype argument, every tensor f32
    assert [c[0] for c in calls] == ["crf_fwd", "logz_fwd", "logz_posteriors",
                                     "crf_bwd"] or sorted(
        c[0] for c in calls) == ["crf_bwd", "crf_fwd", "logz_fwd",
                                 "logz_posteriors"]
    for name, dtypes, kw in calls:
        assert set(dtypes) == {F32}, name
        assert not {"score_dtype", "lattice_dtype", "out_dtype"} & set(kw)
    # the same as the switch set to anything but 1
    monkeypatch.setenv(SWITCH, "0")
    again = _loss_and_grads(lp, seqs, seqlens, scores)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # bit for bit the f32 twins called with no dtype argument
    sidx, midx, mmidx, mfact, valid, last = _port_inputs(lp, seqs, seqlens,
                                                         None, None)
    t_lp = torch.from_numpy(lp)
    fwd, score, lat = tcrf.crf_fwd_plain(t_lp, sidx, midx, mmidx, mfact,
                                         valid)
    score = score + fwd.gather(1, last.long()[:, None])[:, 0]
    s = torch.from_numpy(scores)
    _, z, zlat = tlogz.logz_fwd_plain(s, 4)
    T = lp.shape[0]
    cost = torch.where(torch.from_numpy(seqlens) > 0, -score / T,
                       torch.zeros_like(score))
    assert torch.equal(got[0], cost.sum() + (z + math.log(4)).sum())
    post = tcrf.crf_bwd_plain(t_lp, sidx, midx, mmidx, mfact, lat, valid,
                              last)
    gm = (torch.from_numpy(seqlens) > 0).float()
    assert torch.equal(got[1], (-post / T) * gm[None, :, None])
    assert torch.equal(got[2], tlogz.logz_posteriors_plain(s, zlat, 4))
    # the fused forward's f32 lattice and score, bit for bit the streams
    # twin's (kernel 9's, untouched by the bf16 instances)
    stay_all, move_all = tff._select_streams(t_lp, sidx, midx, None, None)
    f2, s2, lat2 = tcrf.crf_fwd_streams_plain(stay_all, move_all, valid)
    fwd0, score0, _ = tcrf.crf_fwd_plain(t_lp, sidx, midx, mmidx, mfact,
                                         valid)
    assert torch.equal(lat2, lat) and torch.equal(s2, score0)
    assert torch.equal(f2, fwd0)


# -- (d) the other switches, validation, refusals ----------------------------

@pytest.mark.parametrize("other", ["TAIYAKI_TPU_F32_SCORES",
                                   "TAIYAKI_TPU_NO_SCORE_FUSE"])
def test_score_switches_keep_the_streams_route_f32(other, monkeypatch):
    """Under the switch either score switch takes the CRF to the streams
    route, whose streams and logZ's scores are f32 under
    TAIYAKI_TPU_F32_SCORES=1 and bf16 under TAIYAKI_TPU_NO_SCORE_FUSE=1,
    with bf16 lattices and posteriors under either, as the JAX package
    stores them.  (The name is from before the streams route had bf16
    instances, when both cases kept its streams f32.)"""
    lp, seqs, seqlens, _, _ = _case(T=20, B=8, seed=22)
    seqlens[2] = 9
    scores = _scores(20, 8, 4, seed=23)
    calls = []
    _recording(monkeypatch, calls)
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setenv(other, "1")
    sdt = F32 if other == "TAIYAKI_TPU_F32_SCORES" else BF16
    assert tff.score_dtype() == sdt and tff.lattice_dtype() == BF16
    _loss_and_grads(lp, seqs, seqlens, scores)
    seen = {c[0]: c for c in calls}
    assert len(seen) == len(calls) == 4
    assert set(seen) == {"crf_fwd_streams", "crf_grad_streams", "logz_fwd",
                         "logz_posteriors"}
    # (stay, move) and the lattice; (scores) and the lattice, posteriors
    assert seen["crf_fwd_streams"][1] == (sdt, sdt)
    assert seen["crf_fwd_streams"][2]["lattice_dtype"] == BF16
    assert seen["crf_grad_streams"][1] == (sdt, sdt, BF16, F32)  # + mfact
    assert seen["logz_fwd"][1] == (sdt,)
    assert seen["logz_fwd"][2]["lattice_dtype"] == BF16
    assert seen["logz_posteriors"][1] == (sdt, BF16)
    assert seen["logz_posteriors"][2]["out_dtype"] == BF16


def test_switch_runs_the_bf16_instances(monkeypatch):
    lp, seqs, seqlens, _, _ = _case(T=20, B=8, seed=24)
    seqlens[2] = 9
    scores = _scores(20, 8, 4, seed=25)
    calls = []
    _recording(monkeypatch, calls)
    monkeypatch.setenv(SWITCH, "1")
    loss, g_lp, g_s = _loss_and_grads(lp, seqs, seqlens, scores)
    assert g_lp.dtype == g_s.dtype == F32
    seen = {c[0]: c for c in calls}
    assert set(seen) == {"crf_fwd", "crf_bwd", "logz_fwd", "logz_posteriors"}
    assert seen["crf_fwd"][2]["score_dtype"] == BF16
    assert seen["crf_bwd"][2]["score_dtype"] == BF16
    assert BF16 in seen["crf_bwd"][1]                     # its lattice
    assert seen["logz_fwd"][1] == (BF16,)
    assert seen["logz_fwd"][2]["lattice_dtype"] == BF16
    assert seen["logz_posteriors"][1] == (BF16, BF16)
    # validation: no grad, the scores rounded, no lattice
    calls.clear()
    with torch.no_grad():
        v = (tff.crf_flipflop_loss(torch.from_numpy(lp),
                                   torch.from_numpy(seqs),
                                   torch.from_numpy(seqlens)).sum()
             + tff.flipflop_logz(torch.from_numpy(scores)).sum())
    assert [c[0] for c in calls] == ["crf_fwd", "logz_fwd"]
    assert calls[0][2] == {"emit_lattice": False, "score_dtype": BF16}
    assert calls[1][1] == (BF16,)
    assert torch.equal(v, loss)


def test_wrappers_refuse_mixed_dtypes():
    """logZ's wrappers refuse the dtypes of no instance (logz.INSTANCES:
    f32, bf16, and f32 scores with a bf16 lattice and posteriors)."""
    s = torch.from_numpy(_scores(6, 2, 4, seed=26))
    with pytest.raises(ValueError, match="no instance"):
        tlogz.logz_fwd(s.to(BF16), lattice_dtype=F32)
    _, _, lat = tlogz.logz_fwd(s.to(BF16))
    assert lat.dtype == BF16
    with pytest.raises(ValueError, match="no instance"):
        tlogz.logz_posteriors(s, lat)
    with pytest.raises(ValueError, match="no instance"):
        tlogz.logz_posteriors(s.to(BF16), lat, out_dtype=F32)
    lp, seqs, seqlens, _, _ = _case(T=6, B=8, seed=27)
    idx = _port_inputs(lp, seqs, seqlens, None, None)
    t_lp = torch.from_numpy(lp)
    with pytest.raises(ValueError, match="score_dtype"):
        tcrf.crf_fwd(t_lp, *idx[:5], score_dtype=torch.float16)
    _, _, clat = tcrf.crf_fwd(t_lp, *idx[:5])
    with pytest.raises(ValueError, match="lattice"):
        tcrf.crf_bwd(t_lp, *idx[:4], clat, idx[4], idx[5],
                     score_dtype=BF16)


# -- (e) a training step of mLstm_flipflop -----------------------------------

def test_training_step_against_the_f32_step(monkeypatch):
    """Size 16, B=8, chunks of 500 samples (T=100), seed 4: the port's
    step under the switch against its f32 step."""
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    tnet = tmodel.network(**kwargs)
    load_jax_params(tnet, jmodel.network(**kwargs).init(
        np.random.default_rng(4)))
    batch = ttrain.batch_to_device(_batch(n=8), torch.device("cpu"))
    step = ttrain.make_grad_step(tnet)
    loss32, grads32 = step(batch, 1.0)
    counts = {}
    for mod, name in ((tcrf, "crf_fwd"), (tcrf, "crf_bwd"),
                      (tff, "logz_fwd"), (tff, "logz_posteriors")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            dts = {a.dtype for a in args if isinstance(a, torch.Tensor)}
            dts |= set(kw.values())
            key = (_name, BF16 in dts)
            counts[key] = counts.get(key, 0) + 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv(SWITCH, "1")
    loss, grads = step(batch, 1.0)
    assert counts == {(n, True): 1 for n in ("crf_fwd", "crf_bwd",
                                             "logz_fwd", "logz_posteriors")}
    assert abs(float(loss) - float(loss32)) <= 5e-3 * abs(float(loss32))
    for name, g, w in zip(leaf_names(tnet), grads, grads32):
        assert g.dtype == F32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 2e-2 * scale, name


def test_catmod_step_against_the_jax_mixed_step(monkeypatch):
    """A size-16 mLstm_cat_mod step on 8 modref chunks of 500 samples at
    the --mod_factor ramp's start (x8) under the switch, against the JAX
    package's mixed step (TAIYAKI_TPU_PALLAS_INTERPRET=1): within half of
    the JAX route's own distance from its f32 step, which is large here
    (the mod moves' scores round at x8: 1.8e-2 of the head's largest
    gradient, the port 1.3e-5 from the JAX mixed step; chip_smoke.py's
    BF16_CATMOD_GRAD_TOL)."""
    from taiyaki_tpu import train as jtrain
    import test_torch_catmod as catmod
    batch = catmod._modref_batch(jtrain.sample_batch, catmod.jcs,
                                 catmod.jmsf, seed=4, n=8, chunk_len=500)
    jai, tai = catmod._alphabets()
    jnet = catmod.jlstm.network(size=16, alphabet_info=jai)
    params = jnet.init(np.random.default_rng(9))
    tnet = load_jax_params(catmod.tlstm.network(size=16, alphabet_info=tai),
                           params)
    head = jnet.sublayers[-1]
    cat_mod = (True, head.can_mods_offsets,
               np.ones(head.ncan_base + head.nmod_base, np.float32))
    jbatch = jtrain.Batch(*(jnp.asarray(a) for a in batch))
    tbatch = ttrain.batch_to_device(batch, torch.device("cpu"))

    def jstep():
        loss, grads = jax.value_and_grad(jtrain.make_loss_fn(
            jnet, *cat_mod))(params, jbatch, 1.0, 8.0)
        return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]

    def tstep():
        loss, grads = ttrain.make_grad_step(tnet, *cat_mod)(tbatch, 1.0, 8.0)
        return float(loss), [g.numpy() for g in grads]

    j32 = jstep()
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    j16 = jstep()
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    t16 = tstep()

    def dist(a, b):
        """(loss relative, the largest gradient's share of its largest)"""
        return (abs(a[0] - b[0]) / abs(b[0]),
                max(np.abs(x - y).max() / np.abs(y).max()
                    for x, y in zip(a[1], b[1])))
    route, port = dist(j16, j32), dist(t16, j16)
    assert route[1] > 1e-2, route
    assert port[0] <= 0.5 * route[0] and port[1] <= 0.5 * route[1], (
        port, route)


# -- (f) the trainer CLI -----------------------------------------------------

RECORDER = """import json, sys
import torch
from taiyaki_tpu_torch.ops import crf, flipflop
seen = []


def wrap(mod, name):
    real = getattr(mod, name)

    def spy(*args, **kw):
        dts = {x.dtype for x in args if isinstance(x, torch.Tensor)}
        seen.append([name, torch.bfloat16 in dts | set(kw.values()),
                     kw.get("emit_lattice", True)])
        return real(*args, **kw)
    setattr(mod, name, spy)


for n in ("crf_fwd", "crf_bwd", "crf_fwd_streams"):
    wrap(crf, n)
for n in ("logz_fwd", "logz_posteriors"):
    wrap(flipflop, n)
from taiyaki_tpu_torch.cli import train_flipflop
train_flipflop.main(sys.argv[2:])
with open(sys.argv[1], "w") as fh:
    json.dump(seen, fh)
"""


def _cli_run(directory, switch):
    """The port's trainer on the CPU (size 16, 2 iterations, a validation
    at the second) with its CRF and logZ wrappers recorded: (batch.log
    losses, validation loss, [name, bf16, emit_lattice] of each call)."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = str(directory)
    os.makedirs(d, exist_ok=True)
    script, seen = (os.path.join(d, "record.py"),
                    os.path.join(d, "seen.json"))
    with open(script, "w") as fh:
        fh.write(RECORDER)
    env = subprocess_env()
    env.pop(SWITCH, None)
    if switch:
        env[SWITCH] = "1"
    outdir = os.path.join(d, "out")
    r = subprocess.run(
        [sys.executable, script, seen, "--device", "cpu", "--size", "16",
         "--stride", "2", "--winlen", "9", "--niteration", "2",
         "--warmup_batches", "1", "--chunk_len_min", "300",
         "--chunk_len_max", "400", "--min_sub_batch_size", "4",
         "--save_every", "2", "--sample_nreads_before_filtering", "50",
         "--reporting_sub_batches", "10", "--seed", "5", "--quiet",
         "--outdir", outdir,
         os.path.join(repo, "taiyaki_tpu_torch", "models",
                      "mLstm_flipflop.py"),
         os.path.join(repo, "RESULTS", "training_ingredients",
                      "mapped_remap_samref.hdf5")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(seen) as fh:
        calls = json.load(fh)

    def rows(name):
        with open(os.path.join(outdir, name)) as fh:
            return [line.split("\t") for line in fh.read().splitlines()]
    return ([float(row[1]) for row in rows("batch.log")[1:]],
            float(rows("validation.log")[1][1]), calls)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The f32 run and the run under the switch (once a pytest run)."""
    return {s: shared_run(tmp_path_factory, "bf16_scores_cli_{}".format(s),
                          lambda d, s=s: _cli_run(d, s))
            for s in (False, True)}


def test_trainer_cli_under_the_switch(cli_runs):
    losses32, val32, calls32 = cli_runs[False]
    losses, val, calls = cli_runs[True]
    assert len(losses) == len(losses32) == 2
    for a, b in zip(losses + [val], losses32 + [val32]):
        assert math.isfinite(a) and abs(a - b) <= 5e-3 * abs(b), (a, b)
    assert not any(bf for _, bf, _ in calls32)
    assert all(bf for _, bf, _ in calls), calls
    # two training steps, then the validation's sub-batches, whose
    # forwards emit no lattice
    train = [n for n, _, emit in calls if emit]
    assert train == ["crf_fwd", "logz_fwd", "logz_posteriors",
                     "crf_bwd"] * 2
    valid = [n for n, _, emit in calls if not emit]
    assert valid and valid == ["crf_fwd", "logz_fwd"] * (len(valid) // 2)
