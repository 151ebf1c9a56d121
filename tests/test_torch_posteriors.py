"""The arithmetic of the two redesigned posterior kernels, on the CPU.

Row 3 (`logz_posteriors`, csrc/logz.cu) cuts T into segments: each
segment's transfer, a serial pass over the segments for each one's end
vector, each segment rerun from it.  Its plain mirror
`ops.logz.logz_posteriors_segmented` is held against the port's twin and
against the TPU kernel `pallas_logz.logz_backward_posteriors` in
interpret mode: nbase 2 and 4, T of one step, under one segment, not a
multiple of the segment, and a row with no path (-inf scores).

Row 6 (`crf_bwd`, csrc/crf.cu) sums each step's posteriors into the
columns of d lp through per-row column lists built once by a stable
counting sort; `ops.crf.column_lists` builds them as the kernel does, and
the twin's posteriors (the streams twin's, per position) summed through
them in list order must give `crf_bwd_plain`'s d lp, at nmod 0 and 3.

Same seeded numpy inputs for every package.  Tolerances: posteriors
atol 1e-5 (probabilities in [0, 1], sums in another order); the
segmented mirror also against the twin at 2e-6 (the same log-space steps,
regrouped); d lp through the lists atol 1e-5 times the largest mod
weight (the twin's scatter sums in another order)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import flipflopfings as jfff
from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_logz
from taiyaki_tpu_torch.ops import crf, flipflop, logz
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)


def _scores(T, B, nbase, seed, no_path=None):
    rng = np.random.default_rng(seed)
    S = 2 * nbase * (nbase + 1)
    s = (5.0 * np.tanh(rng.normal(size=(T, B, S)))).astype(np.float32)
    if no_path is not None:
        s[:, no_path] = -np.inf
    return s


@functools.lru_cache(maxsize=None)
def _pallas_posteriors(T, B, nbase, seed):
    """The TPU kernels' posteriors in interpret mode, sliced back from
    their lane and time padding (computed once a shape)."""
    s = _scores(T, B, nbase, seed)
    bt = pallas_logz.DEFAULT_BLOCK_T
    scores_p = jff._logz_pad_scores(jnp.asarray(s), bt, dtype=jnp.float32)
    _, _, lattice_p = pallas_logz.logz_forward(scores_p, nbase, block_t=bt,
                                               interpret=True)
    post_p = pallas_logz.logz_backward_posteriors(
        scores_p, lattice_p, nbase, block_t=bt, interpret=True)
    return np.asarray(post_p)[:T, :, :s.shape[2]]


# (nbase, T, segment): T of one step, under one segment, one segment and
# one step more, not a multiple of the segment, many segments
SEGMENTED = [(4, 1, 16), (4, 9, 16), (4, 17, 16), (4, 37, 8), (4, 40, 3),
             (2, 1, 2), (2, 13, 16), (2, 33, 4), (2, 40, 7)]


@pytest.mark.parametrize("nbase,T,segment", SEGMENTED)
def test_segmented_posteriors_match_twin_and_pallas(nbase, T, segment):
    B = 5
    s = torch.from_numpy(_scores(T, B, nbase, seed=T + nbase))
    _, _, lattice = logz.logz_fwd_plain(s, nbase)
    want = logz.logz_posteriors_plain(s, lattice, nbase)
    got = logz.logz_posteriors_segmented(s, lattice, nbase, segment)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(),
                               _pallas_posteriors(T, B, nbase, T + nbase),
                               atol=1e-5)
    np.testing.assert_allclose(got.sum(dim=2).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("nbase,T,segment", [(4, 37, 8), (2, 20, 3),
                                             (4, 5, 16)])
def test_segmented_posteriors_no_path_row(nbase, T, segment):
    """A row of -inf scores: zeros, no NaN, the other rows as the twin's
    and the TPU kernel's."""
    B = 4
    s = torch.from_numpy(_scores(T, B, nbase, seed=T + nbase, no_path=2))
    _, logz_, lattice = logz.logz_fwd_plain(s, nbase)
    got = logz.logz_posteriors_segmented(s, lattice, nbase, segment)
    assert logz_[2] == -math.inf
    assert not torch.isnan(got).any()
    assert (got[:, 2] == 0).all()
    torch.testing.assert_close(
        got, logz.logz_posteriors_plain(s, lattice, nbase), rtol=0,
        atol=2e-6)
    keep = [0, 1, 3]
    np.testing.assert_allclose(
        got[:, keep].numpy(),
        _pallas_posteriors(T, B, nbase, T + nbase)[:, keep], atol=1e-5)


def _crf_case(nmod, seed, T=30, B=6, L=40):
    """Scores and ragged sequences (row 1 empty; row 2, where L > T + 1,
    longer than T steps can cross: no path), the index vectors of
    ops.crf; with nmod, a weighted mod column on every move (weights up to
    8)."""
    rng = np.random.default_rng(seed)
    S = 40 + (1 + nmod if nmod else 0)
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    seqlens = rng.integers(2, min(L, T) + 1, size=B).astype(np.int32)
    seqlens[1] = 0
    if L > T + 1:
        seqlens[2] = L
    seqs = np.zeros((B, L), np.int32)
    for b in range(B):
        seqs[b, :seqlens[b]] = jfff.flipflop_code(
            rng.integers(0, 4, size=seqlens[b]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = mf = None
    if nmod:
        mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1))
                              .astype(np.int32))
        mf = torch.from_numpy(rng.uniform(0.1, 8.0, size=(B, L - 1))
                              .astype(np.float32))
    idx = flipflop._lattice_inputs(stay, move, torch.from_numpy(seqlens), S,
                                   mm, mf)
    return lp, idx


@pytest.mark.parametrize("nmod", [0, 3])
def test_column_lists_sum_twin_posteriors_to_crf_bwd(nmod):
    lp, (sidx, midx, mmidx, mfact, valid, last) = _crf_case(nmod, 5 + nmod)
    T, B, S = lp.shape
    _, _, lattice = crf.crf_fwd_plain(lp, sidx, midx, mmidx, mfact, valid)
    want = crf.crf_bwd_plain(lp, sidx, midx, mmidx, mfact, lattice, valid,
                             last)
    stay, move = flipflop._select_streams(lp, sidx, midx, mmidx, mfact)
    _, _, lat_s = crf.crf_fwd_streams_plain(stay, move, valid)
    post_stay, post_move = crf.crf_bwd_posteriors_plain(stay, move, lat_s,
                                                        valid, last)
    got = torch.zeros_like(want)
    for b in range(B):
        ent, off, choff, chst = crf.column_lists(
            sidx[b], midx[b], mmidx[b], mfact[b], valid[b], last[b], S)
        pos, kind = ent // 4, ent % 4
        # each entry's posterior at every step, in list order
        val = torch.where(kind == 0, post_stay[:, b, pos],
                          post_move[:, b, pos])
        val = torch.where(kind == 2, mfact[b, pos] * val, val)
        den = torch.zeros(T)
        for j in range(S + 1):
            for q in range(int(choff[j]), int(choff[j + 1])):
                part = val[:, int(chst[q]):int(chst[q + 1])].sum(dim=1)
                if j < S:
                    got[:, b, j] += part
                sm = kind[int(chst[q]):int(chst[q + 1])] < 2
                den += val[:, int(chst[q]):int(chst[q + 1])][:, sm].sum(1)
        # the stays and moves of a row with a path sum to 1 at every step
        if b not in (1, 2):
            torch.testing.assert_close(den, torch.ones(T), rtol=1e-5,
                                       atol=0)
    atol = 1e-5 * max(1.0, mfact.max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    for b in (1, 2):
        assert not want[:, b].any() and not got[:, b].any()


def test_column_lists_are_stable_and_chunked():
    """The lists in (column, position, kind) order, every contribution
    once, chunks of at most BWD_CHUNK entries that never cross a
    column."""
    lp, (sidx, midx, mmidx, mfact, valid, last) = _crf_case(
        3, 9, T=200, B=3, L=150)
    S = lp.shape[2]
    for b in range(3):
        ent, off, choff, chst = crf.column_lists(
            sidx[b], midx[b], mmidx[b], mfact[b], valid[b], last[b], S)
        nvalid = int(valid[b].sum())
        nmove = max(0, int(last[b]))
        nmod = int(((mfact[b][:nmove] != 0)
                    & (mmidx[b][:nmove] < S)).sum()) if nvalid else 0
        assert len(ent) == nvalid + (nmove + nmod if nvalid else 0)
        assert int(off[-1]) == len(ent) == int(chst[-1])
        for j in range(S + 1):
            seg = ent[int(off[j]):int(off[j + 1])]
            assert (seg[1:] > seg[:-1]).all()
            starts = chst[int(choff[j]):int(choff[j + 1])]
            assert (starts == torch.arange(int(off[j]), int(off[j + 1]),
                                           crf.BWD_CHUNK)).all()
        assert (chst[1:] - chst[:-1] <= crf.BWD_CHUNK).all()
