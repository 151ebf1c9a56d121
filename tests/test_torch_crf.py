"""The CRF lattice forward and backward (kernels 5-6) and the flip-flop
loss and logZ gradient of the port, as plain twins on the CPU, against the
JAX package: the fused TPU kernels in interpret mode, the f32 CPU scan, the
reference C kernel's fixture, and jax.grad.  Same seeded numpy inputs.

Tolerances: against the scan and jax.grad, 1e-5 (f32, the same DP in
another order); against the fused TPU kernels, the bf16 tolerance of the
JAX package's own test of them (tests/test_pallas_crf.py): their selector
and score scratch is bf16, so each selected score carries a relative
rounding of 2^-9 (score rtol 5e-3, atol 5e-2; gradient rtol 2e-2, atol
5e-3); against the reference C kernel, the JAX package's pins (cost 1e-6,
gradient 2e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import flipflopfings as jfff
from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_crf
from taiyaki_tpu_torch.ops import crf as tcrf
from taiyaki_tpu_torch.ops import flipflop as tff

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "ref_ctc_selftest.npz")


def _case(T=10, B=8, L=14, nmod=0, seed=0):
    """Scores and ragged sequences: row 1 empty, row 2 with no path
    (L-1 > T positions to cross in T steps), the rest random lengths."""
    rng = np.random.default_rng(seed)
    S = 40 + (1 + nmod if nmod else 0)
    lp = rng.normal(size=(T, B, S)).astype(np.float32)
    seqlens = rng.integers(2, min(L, T) + 1, size=B).astype(np.int32)
    seqlens[1] = 0
    seqlens[2] = L
    seqs = np.zeros((B, L), np.int32)
    for b in range(B):
        seqs[b, :seqlens[b]] = jfff.flipflop_code(
            rng.integers(0, 4, size=seqlens[b]))
    mm = mf = None
    if nmod:
        mm = rng.integers(40, S, size=(B, L - 1)).astype(np.int32)
        mf = rng.uniform(0.1, 1.0, size=(B, L - 1)).astype(np.float32)
    return lp, seqs, seqlens, mm, mf


def _port(lp, seqs, seqlens, mm, mf):
    """(score with the final position's term, d score / d lp) of the
    port's twins."""
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    idx = tff._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), lp.shape[2],
        None if mm is None else torch.from_numpy(mm),
        None if mf is None else torch.from_numpy(mf))
    sidx, midx, mmidx, mfact, valid, last = idx
    t_lp = torch.from_numpy(lp)
    fwd, score, lattice = tcrf.crf_fwd(t_lp, sidx, midx, mmidx, mfact, valid)
    score = score + fwd.gather(1, last.long()[:, None])[:, 0]
    grad = tcrf.crf_bwd(t_lp, sidx, midx, mmidx, mfact, lattice, valid, last)
    return score.numpy(), grad.numpy()


@pytest.mark.parametrize("nmod", [0, 3])
def test_crf_twins_match_scan(nmod):
    lp, seqs, seqlens, mm, mf = _case(nmod=nmod, seed=nmod)
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    score, grad = jff._grad_scores(
        jnp.asarray(lp), stay, move,
        None if mm is None else jnp.asarray(mm),
        None if mf is None else jnp.asarray(mf), jnp.asarray(seqlens))
    got_s, got_g = _port(lp, seqs, seqlens, mm, mf)
    has_path = np.array([b != 2 for b in range(len(seqlens))])
    np.testing.assert_allclose(got_s[has_path], np.asarray(score)[has_path],
                               rtol=1e-5, atol=1e-5)
    assert got_s[2] < -1e29 and np.asarray(score)[2] < -1e29
    np.testing.assert_allclose(got_g, np.asarray(grad), rtol=1e-5,
                               atol=1e-5)
    assert not got_g[:, 1].any() and not got_g[:, 2].any()


@pytest.mark.parametrize("nmod", [0, 3])
def test_crf_twins_match_fused_pallas_kernels(nmod):
    """Against crf_forward_fused / crf_backward_fused in interpret mode,
    index vectors lane-padded as ops/flipflop.py pads them."""
    T, bt = 10, 4
    lp, seqs, seqlens, mm, mf = _case(T=T, nmod=nmod, seed=10 + nmod)
    L = seqs.shape[1]
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    valid = jnp.arange(L)[None, :] < jnp.asarray(seqlens)[:, None]
    setup = jff._fused_setup(
        jnp.asarray(lp), stay, move, None if mm is None else jnp.asarray(mm),
        None if mf is None else jnp.asarray(mf), valid)
    _, bb, _, idxs, _, valid_p = setup
    lp_p = jff._pad_axis(jnp.asarray(lp), 0, bt, 0.0)
    fwd, score, lattice = pallas_crf.crf_forward_fused(
        lp_p, *idxs, valid_p, block_b=bb, block_t=bt, true_len=T,
        interpret=True)
    last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    score = score + jnp.take_along_axis(fwd[:, :L], last[:, None],
                                        axis=1)[:, 0]
    grad = pallas_crf.crf_backward_fused(
        lp_p, *idxs, lattice, valid_p, last[:, None].astype(jnp.int32),
        block_b=bb, block_t=bt, true_len=T, interpret=True)[:T]
    got_s, got_g = _port(lp, seqs, seqlens, mm, mf)
    # the empty row's score (masked out of the cost) sums NEG over the
    # TPU kernel's padded steps too; only rows with a path compare
    has_path = np.array([b not in (1, 2) for b in range(len(seqlens))])
    np.testing.assert_allclose(got_s[has_path], np.asarray(score)[has_path],
                               rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(got_g, np.asarray(grad), rtol=2e-2,
                               atol=5e-3)


def test_crf_lattice_matches_scan_lattice():
    lp, seqs, seqlens, _, _ = _case(seed=4)
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    sel_stay, sel_move = jff._make_selectors(stay, move, None, None, 40)
    stay_all, move_all = jff._select_all_scores(jnp.asarray(lp), sel_stay,
                                                sel_move)
    valid = jnp.arange(seqs.shape[1])[None, :] < jnp.asarray(seqlens)[:, None]
    _, want = jff._forward_scores_streams(stay_all, move_all, valid,
                                          jnp.asarray(seqlens), True)
    tstay, tmove = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    sidx, midx, mmidx, mfact, tvalid, _ = tff._lattice_inputs(
        tstay, tmove, torch.from_numpy(seqlens), 40)
    _, _, got = tcrf.crf_fwd(torch.from_numpy(lp), sidx, midx, mmidx, mfact,
                             tvalid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_make_seq_indices_matches_jax():
    _, seqs, _, _, _ = _case(seed=5)
    want = jff.make_seq_indices(jnp.asarray(seqs), 4)
    got = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_loss_pinned_on_reference_kernel_fixture():
    """The reference C kernel's own fixture: cost = -score/nblk and its
    gradient -grad_C/nblk."""
    data = np.load(FIXTURE)
    nblk = data["crf_logprob"].shape[0]
    lp = torch.from_numpy(data["crf_logprob"].astype(np.float32))
    lp.requires_grad_()
    cost = tff.crf_flipflop_loss(lp, torch.from_numpy(data["crf_seq"]),
                                 torch.from_numpy(data["crf_seqlen"]), 1.0)
    np.testing.assert_allclose(cost.detach().numpy(),
                               -data["crf_score"] / nblk, atol=1e-6)
    cost.sum().backward()
    np.testing.assert_allclose(lp.grad.numpy(), -data["crf_grad"] / nblk,
                               atol=2e-5)


def test_loss_and_gradient_match_jax_with_sharpening():
    """crf_flipflop_loss as an autograd Function against jax.vjp, with
    sharpening, an empty row (cost 0, no gradient) and ragged rows."""
    lp, seqs, seqlens, _, _ = _case(seed=6)
    seqlens[2] = 5              # a row with a path
    g = np.random.default_rng(1).normal(size=len(seqlens)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda x: jff.crf_flipflop_loss(
        x, jnp.asarray(seqs), jnp.asarray(seqlens), 1.7), jnp.asarray(lp))
    t_lp = torch.from_numpy(lp).requires_grad_()
    got = tff.crf_flipflop_loss(t_lp, torch.from_numpy(seqs),
                                torch.from_numpy(seqlens), 1.7)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert got[1].item() == 0.0
    np.testing.assert_allclose(t_lp.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)
    assert not t_lp.grad[:, 1].any()


def test_loss_and_gradient_match_jax_above_2048_positions():
    """A lattice of 2304 positions (more than the 2048 the CUDA kernels
    once took) against the JAX package's scan path, loss and gradient."""
    T, L = 2600, 2304
    rng = np.random.default_rng(12)
    lp = rng.normal(size=(T, 2, 40)).astype(np.float32)
    seqlens = np.array([L, 1700], np.int32)
    seqs = np.zeros((2, L), np.int32)
    for b in range(2):
        seqs[b, :seqlens[b]] = jfff.flipflop_code(
            rng.integers(0, 4, size=seqlens[b]))
    want, vjp = jax.vjp(lambda x: jff.crf_flipflop_loss(
        x, jnp.asarray(seqs), jnp.asarray(seqlens), 1.0), jnp.asarray(lp))
    t_lp = torch.from_numpy(lp).requires_grad_()
    got = tff.crf_flipflop_loss(t_lp, torch.from_numpy(seqs),
                                torch.from_numpy(seqlens), 1.0)
    got.sum().backward()
    assert tcrf.MAX_L >= 4096
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_lp.grad.numpy(),
                               np.asarray(vjp(jnp.ones(2))[0]),
                               rtol=1e-5, atol=1e-6)


def test_loss_without_grad_skips_the_lattice(monkeypatch):
    lp, seqs, seqlens, _, _ = _case(seed=7)
    seen = []
    real = tcrf.crf_fwd

    def spy(*args, emit_lattice=True):
        seen.append(emit_lattice)
        return real(*args, emit_lattice=emit_lattice)
    monkeypatch.setattr(tcrf, "crf_fwd", spy)
    with torch.no_grad():
        a = tff.crf_flipflop_loss(torch.from_numpy(lp),
                                  torch.from_numpy(seqs),
                                  torch.from_numpy(seqlens))
    b = tff.crf_flipflop_loss(torch.from_numpy(lp).requires_grad_(),
                              torch.from_numpy(seqs),
                              torch.from_numpy(seqlens))
    assert seen == [False, True]
    assert torch.equal(a, b.detach())


def test_logz_gradient_matches_jax_grad():
    rng = np.random.default_rng(8)
    s = (5.0 * np.tanh(rng.normal(size=(30, 5, 40)))).astype(np.float32)
    g = rng.normal(size=5).astype(np.float32)
    want, vjp = jax.vjp(jff.flipflop_logz, jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_()
    got = tff.flipflop_logz(ts)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_crf_wrappers_reject_other_devices():
    """A tensor on a device other than the CPU or a card is refused."""
    lp, seqs, seqlens, _, _ = _case(seed=9)
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    idx = tff._lattice_inputs(stay, move, torch.from_numpy(seqlens), 40)
    with pytest.raises(ValueError, match="CUDA"):
        tcrf.crf_fwd(torch.from_numpy(lp).to("meta"), *idx[:5])
