"""Kernel 10's split on the CPU: the plain backward chain
(`crf.crf_bwd_chain_plain`) and posterior pass (`crf.crf_post_pass_plain`)
that the redesigned kernel runs as two launches, the route's d lp entry
(`crf.crf_grad_streams`, plain twin: the posteriors scattered into their
columns) and the Python mirror of the stream chains' bands
(`crf.streams_layout`).  Same seeded numpy inputs as
tests/test_torch_crf_streams.py, with its empty row and its row with no
path.

Tolerances: 1e-5 against the Pallas kernels in interpret mode and the JAX
route (f32 streams, the same recursions in another order); 1e-6 between
two port twins that sum the same posteriors in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_crf
from taiyaki_tpu_torch.ops import crf as tcrf
from taiyaki_tpu_torch.ops import flipflop as tff
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)
from test_torch_crf_streams import _case, _streams, _t


def _port_streams(lp, seqs, seqlens, mm, mf):
    """The port's streams, forward lattice and index vectors of the same
    inputs: (stay_all, move_all, lattice, valid, last, sidx, midx, mmidx,
    mfact)."""
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    idx = tff._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), lp.shape[2],
        None if mm is None else torch.from_numpy(mm),
        None if mf is None else torch.from_numpy(mf))
    sidx, midx, mmidx, mfact, valid, last = idx
    mod = (None, None) if mm is None else (mmidx, mfact)
    stay_all, move_all = tff._select_streams(torch.from_numpy(lp), sidx,
                                             midx, *mod)
    _, _, lattice = tcrf.crf_fwd_streams_plain(stay_all, move_all, valid)
    return stay_all, move_all, lattice, valid, last, sidx, midx, mmidx, mfact


@pytest.mark.parametrize("nmod", [0, 3])
def test_chain_and_pass_give_the_posteriors(nmod):
    """The plain backward chain, then the plain posterior pass on its
    backward lattice, give `crf_bwd_posteriors_plain`'s posteriors and the
    Pallas kernel's (interpret mode, f32 streams); rows with no path or no
    positions get zeros."""
    T, bt = 12, 8
    lp, seqs, seqlens, mm, mf = _case(T=T, nmod=nmod, seed=60 + nmod)
    L = seqs.shape[1]
    stay_all, move_all, lattice, valid, last = _port_streams(
        lp, seqs, seqlens, mm, mf)[:5]
    blat = tcrf.crf_bwd_chain_plain(stay_all, move_all, valid, last)
    got = tcrf.crf_post_pass_plain(stay_all, move_all, lattice, blat, valid,
                                   last)
    want = tcrf.crf_bwd_posteriors_plain(stay_all, move_all, lattice, valid,
                                         last)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the Pallas pair on its own padded f32 streams
    j_stay, j_move, j_valid = _streams(lp, seqs, seqlens, mm, mf)
    stay_p, move_p, valid_p = jff._pallas_lattice_inputs(
        j_stay, j_move, j_valid, bt, dtype=jnp.float32)
    j_last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    _, _, j_lat = pallas_crf.crf_forward(stay_p, move_p, valid_p,
                                         block_t=bt, interpret=True)
    post_s, post_m = pallas_crf.crf_backward_posteriors(
        stay_p, move_p, j_lat, valid_p, j_last[:, None].astype(jnp.int32),
        block_t=4, interpret=True)
    live = valid.numpy()[None] != 0
    for g, w in zip(got, (post_s, post_m)):
        w = np.asarray(w)[:T, :, :L]
        np.testing.assert_allclose(np.where(live, g.numpy(), 0),
                                   np.where(live, w, 0), rtol=1e-5,
                                   atol=1e-5)
    for g in got:
        assert not g[:, 1].any() and not g[:, 2].any()


def test_chain_is_the_twins_recursion():
    """The backward lattice starts at 0 on each row's last position (NEG
    elsewhere, NEG everywhere on the empty row), and each step's vector is
    renormalised to a maximum of 0 on rows with positions."""
    lp, seqs, seqlens, mm, mf = _case(seed=61)
    stay_all, move_all, _, valid, last = _port_streams(
        lp, seqs, seqlens, mm, mf)[:5]
    blat = tcrf.crf_bwd_chain_plain(stay_all, move_all, valid, last)
    start = blat[-1]
    for b, n in enumerate(seqlens):
        want = np.full(seqs.shape[1], tcrf.NEG, np.float32)
        if n:
            want[n - 1] = 0.0
        np.testing.assert_array_equal(start[b].numpy(), want)
    rows = torch.from_numpy(seqlens > 0)
    np.testing.assert_array_equal(blat[:, rows].amax(dim=2).numpy(), 0.0)


@pytest.mark.parametrize("nmod", [0, 3])
def test_grad_plain_is_the_scatter(nmod):
    """`crf_grad_streams` on the CPU (its plain twin) equals the route's
    posteriors scattered by `_scatter_posteriors`; with no mod column the
    route's padding column (index S, weight 0) adds nothing."""
    lp, seqs, seqlens, mm, mf = _case(nmod=nmod, seed=62 + nmod)
    S = lp.shape[2]
    stay_all, move_all, lattice, valid, last, sidx, midx, mmidx, mfact = \
        _port_streams(lp, seqs, seqlens, mm, mf)
    got = tcrf.crf_grad_streams(stay_all, move_all, lattice, valid, last,
                                sidx, midx, mmidx, mfact, S)
    post = tcrf.crf_bwd_posteriors(stay_all, move_all, lattice, valid, last)
    mod = (None, None) if mm is None else (mmidx, mfact)
    want = tff._scatter_posteriors(lp.shape, *post, sidx, midx, *mod)
    assert got.shape == (lp.shape[0], lp.shape[1], S)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _jax_route_grad(lp, seqs, seqlens, mm, mf):
    """The JAX package's unfused route under TAIYAKI_TPU_F32_SCORES=1:
    f32 streams by `_select_all_scores`, the Pallas pair in interpret mode,
    the posteriors scattered by the one-hot einsums (HIGHEST precision)."""
    T, bt = lp.shape[0], 8
    L = seqs.shape[1]
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    sel_stay, sel_move = jff._make_selectors(
        stay, move, None if mm is None else jnp.asarray(mm),
        None if mf is None else jnp.asarray(mf), lp.shape[2])
    stay_all, move_all = jff._select_all_scores(jnp.asarray(lp), sel_stay,
                                                sel_move)
    valid = jnp.arange(L)[None, :] < jnp.asarray(seqlens)[:, None]
    stay_p, move_p, valid_p = jff._pallas_lattice_inputs(
        stay_all, move_all, valid, bt, dtype=jnp.float32)
    last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    _, _, lattice = pallas_crf.crf_forward(stay_p, move_p, valid_p,
                                           block_t=bt, interpret=True)
    post_s, post_m = pallas_crf.crf_backward_posteriors(
        stay_p, move_p, lattice, valid_p, last[:, None].astype(jnp.int32),
        block_t=4, interpret=True)
    hi = jnp.einsum("tbl,bls->tbs", post_s[:T, :, :L], sel_stay,
                    precision="highest")
    return np.asarray(hi + jnp.einsum("tbl,bls->tbs",
                                      post_m[:T, :, :L - 1], sel_move,
                                      precision="highest"))


@pytest.mark.parametrize("nmod", [0, 3, 109])
def test_grad_matches_the_jax_route(nmod, monkeypatch):
    """`crf_grad_streams` (plain twin, on the port's gathered streams and
    forward lattice) equals the JAX route's d score / d lp, canonical and
    cat_mod columns, and at S = 150 > 128 columns (nmod 109), which only
    the streams route serves."""
    monkeypatch.setenv("TAIYAKI_TPU_F32_SCORES", "1")
    lp, seqs, seqlens, mm, mf = _case(nmod=nmod, seed=64 + nmod)
    S = lp.shape[2]
    assert (S > 128) == (nmod == 109)
    got = tcrf.crf_grad_streams(*_port_streams(lp, seqs, seqlens, mm, mf),
                                S)
    want = _jax_route_grad(lp, seqs, seqlens, mm, mf)
    np.testing.assert_allclose(got.numpy()[..., :40], want[..., :40],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[..., 40:], want[..., 40:],
                               rtol=1e-5, atol=1e-5)
    assert not got[:, 1].any() and not got[:, 2].any()


# (L, the layout csrc/crf.cu's TT_STREAM_BANDS takes there): each band's
# widest lattice and the first past it
BAND_EDGES = [
    (1, (32, 2, 1)), (64, (32, 2, 1)), (65, (64, 2, 1)),
    (1024, (512, 2, 1)), (1025, (544, 2, 1)), (2048, (1024, 2, 1)),
    (2049, (544, 4, 1)), (4096, (1024, 4, 1)), (4097, (544, 4, 2)),
    (8192, (1024, 4, 2)), (8193, (544, 4, 4)), (16384, (1024, 4, 4)),
    (16385, (544, 4, 8)), (32768, (1024, 4, 8)), (32769, None), (0, None)]


@pytest.mark.parametrize("L,want", BAND_EDGES)
def test_streams_layout_at_band_edges(L, want):
    """The mirror of the stream chains' bands at every band edge: kernel
    5's bands to 8192 positions, then clusters of 4 and 8 CTAs, the
    device-memory instance past MAX_L_STREAMS; each layout holds L on at
    most 1024 threads a CTA."""
    got = tcrf.streams_layout(L)
    assert got == want
    if got is not None:
        threads, p, cl = got
        assert threads * p * cl >= L and threads <= 1024 and threads % 32 == 0
    assert tcrf.MAX_L_STREAMS == tcrf.STREAM_BANDS[-1][0]


def test_grad_wrapper_rejects_other_devices():
    lp, seqs, seqlens, mm, mf = _case(seed=66)
    args = [a.to("meta") for a in _port_streams(lp, seqs, seqlens, mm, mf)]
    with pytest.raises(ValueError, match="CUDA"):
        tcrf.crf_grad_streams(*args, lp.shape[2])
