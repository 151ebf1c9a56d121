"""The score-stream route of the port's CRF loss on the CPU: the plain
twins of kernels 9-10 (`crf_fwd_streams`, `crf_bwd_posteriors`) against
the unfused TPU kernels `pallas_crf.crf_forward` and
`crf_backward_posteriors` in interpret mode at f32 streams, and the route
through `crf_flipflop_loss` and `cat_mod_flipflop_loss` under the JAX
trainer's switches and past the fused kernels' width, against the JAX
package's f32 CPU scan (jax.vjp) and the port's fused route.  Same seeded
numpy inputs.

Tolerances: 1e-5 (f32, the same recursions in another order: the Pallas
kernels pad T and L and renormalise the same way; the route's gather,
scatter and kernels against the scan's one-hot einsums)."""

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

SWITCHES = ("TAIYAKI_TPU_NO_SCORE_FUSE", "TAIYAKI_TPU_F32_SCORES")


def _case(T=12, B=6, L=14, nmod=0, seed=0):
    """Scores and ragged sequences: row 1 empty, row 2 with no path
    (L-1 > T positions to cross in T steps), the rest random lengths;
    with nmod, cat_mod columns past the 40 transitions, random mod
    categories and weights."""
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


def _streams(lp, seqs, seqlens, mm, mf):
    """The JAX package's f32 streams (HIGHEST-precision one-hot einsums)
    and valid."""
    stay, move = jff.make_seq_indices(jnp.asarray(seqs), 4)
    sel_stay, sel_move = jff._make_selectors(
        stay, move, None if mm is None else jnp.asarray(mm),
        None if mf is None else jnp.asarray(mf), lp.shape[2])
    stay_all, move_all = jff._select_all_scores(jnp.asarray(lp), sel_stay,
                                                sel_move)
    valid = jnp.arange(seqs.shape[1])[None, :] < jnp.asarray(seqlens)[:, None]
    return stay_all, move_all, valid


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nmod", [0, 3])
def test_stream_twins_match_unfused_pallas_kernels(nmod):
    """Kernels 9-10's twins on the Pallas kernels' own padded f32 inputs
    (L to 128 lanes, T to the block), then on the unpadded streams:
    scores of rows with a path, the lattice and both posteriors on the
    valid columns."""
    T, bt = 12, 8
    lp, seqs, seqlens, mm, mf = _case(T=T, nmod=nmod, seed=20 + nmod)
    L = seqs.shape[1]
    stay_all, move_all, valid = _streams(lp, seqs, seqlens, mm, mf)
    stay_p, move_p, valid_p = jff._pallas_lattice_inputs(
        stay_all, move_all, valid, bt, dtype=jnp.float32)
    last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    fwd, score, lattice = pallas_crf.crf_forward(
        stay_p, move_p, valid_p, block_t=bt, interpret=True)
    post_s, post_m = pallas_crf.crf_backward_posteriors(
        stay_p, move_p, lattice, valid_p, last[:, None].astype(jnp.int32),
        block_t=4, interpret=True)
    want_score = np.asarray(score + jnp.take_along_axis(
        fwd[:, :L], last[:, None], axis=1)[:, 0])
    has_path = np.array([b not in (1, 2) for b in range(len(seqlens))])
    live = np.asarray(valid)[None]
    t_last = _t(last).int()

    for padded in (True, False):
        if padded:
            args = (_t(stay_p), _t(move_p), _t(valid_p).int())
        else:
            # the JAX move stream has L-1 columns; column L-1 is never a
            # transition, whatever it holds
            move = np.pad(np.asarray(move_all), [(0, 0), (0, 0), (0, 1)],
                          constant_values=7.0)
            args = (_t(stay_all), _t(move), _t(valid).int())
        g_fwd, g_score, g_lat = tcrf.crf_fwd_streams(*args)
        g_ps, g_pm = tcrf.crf_bwd_posteriors(args[0], args[1], g_lat,
                                             args[2], t_last)
        got_score = (g_score + g_fwd.gather(1, t_last.long()[:, None])[:, 0]
                     ).numpy()
        np.testing.assert_allclose(got_score[has_path], want_score[has_path],
                                   rtol=1e-5, atol=1e-5)
        for got, want in ((g_lat, lattice), (g_ps, post_s), (g_pm, post_m)):
            got = got.numpy()[:T, :, :L]
            want = np.asarray(want)[:T, :, :L]
            np.testing.assert_allclose(np.where(live, got, 0),
                                       np.where(live, want, 0), rtol=1e-5,
                                       atol=1e-5)
        # no path, or no positions: all-zero posteriors
        for post in (g_ps, g_pm):
            assert not post[:, 1].any() and not post[:, 2].any()


def test_stream_twins_give_the_fused_twins_gradient():
    """Posteriors scattered into their columns equal the fused backward's
    d score / d lp on the same lattice (both plain twins)."""
    lp, seqs, seqlens, mm, mf = _case(nmod=2, seed=3)
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    idx = tff._lattice_inputs(stay, move, torch.from_numpy(seqlens),
                              lp.shape[2], torch.from_numpy(mm),
                              torch.from_numpy(mf))
    sidx, midx, mmidx, mfact, valid, last = idx
    t_lp = torch.from_numpy(lp)
    stay_all, move_all = tff._select_streams(t_lp, sidx, midx, mmidx, mfact)
    _, _, lattice = tcrf.crf_fwd_streams(stay_all, move_all, valid)
    post = tff._scatter_posteriors(t_lp.shape, *tcrf.crf_bwd_posteriors(
        stay_all, move_all, lattice, valid, last), sidx, midx, mmidx, mfact)
    _, _, f_lattice = tcrf.crf_fwd(t_lp, sidx, midx, mmidx, mfact, valid)
    want = tcrf.crf_bwd(t_lp, sidx, midx, mmidx, mfact, f_lattice, valid,
                        last)
    np.testing.assert_allclose(post.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


class _Counts:
    """Counts the calls of the CRF entry points the loss may reach."""

    NAMES = ("crf_fwd", "crf_bwd", "crf_fwd_streams", "crf_bwd_posteriors",
             "crf_grad_streams")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(tcrf, name)

            def spy(*args, _real=real, _name=name, **kwargs):
                self.n[_name] += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(tcrf, name, spy)


def _mod_inputs(rng, seqs, nmods=(1, 0, 2, 0)):
    offsets = np.cumsum(np.concatenate([[0], np.array(nmods) + 1])).astype(
        np.int32)
    mod_cats = np.zeros(seqs.shape, np.int32)
    for b in range(seqs.shape[0]):
        for i, base in enumerate(seqs[b] % 4):
            if nmods[base] and rng.random() < 0.5:
                mod_cats[b, i] = rng.integers(1, nmods[base] + 1)
    weights = rng.uniform(0.5, 2.0, size=int(offsets[-1])).astype(
        np.float32)
    return mod_cats, offsets, weights


def _losses(kind, seqs, seqlens, sharpfact, rng):
    """(JAX loss of x, port loss of x) for `kind`, on fixed sequences."""
    if kind == "crf":
        return (lambda x: jff.crf_flipflop_loss(
                    x, jnp.asarray(seqs), jnp.asarray(seqlens), sharpfact),
                lambda x: tff.crf_flipflop_loss(
                    x, torch.from_numpy(seqs), torch.from_numpy(seqlens),
                    sharpfact), 0)
    mod_cats, offsets, weights = _mod_inputs(rng, seqs)
    return (lambda x: jff.cat_mod_flipflop_loss(
                x, jnp.asarray(seqs), jnp.asarray(seqlens),
                jnp.asarray(mod_cats), offsets, weights, sharpfact),
            lambda x: tff.cat_mod_flipflop_loss(
                x, torch.from_numpy(seqs), torch.from_numpy(seqlens),
                torch.from_numpy(mod_cats), offsets, weights, sharpfact),
            int(offsets[-1]))


@pytest.mark.parametrize("route", ["NO_SCORE_FUSE", "F32_SCORES", "MAX_L"])
@pytest.mark.parametrize("kind", ["crf", "cat_mod"])
def test_loss_takes_the_stream_route(route, kind, monkeypatch):
    """Under either switch, or with the fused kernels' width limit below
    the lattice, the loss runs kernels 9-10's twins (and not 5-6's); its
    value and gradient equal the JAX scan's (jax.vjp) and the fused
    route's.  The streams route's backward is `crf_grad_streams` (the
    posteriors summed into d lp), not `crf_bwd_posteriors` and a
    scatter."""
    rng = np.random.default_rng(40)
    lp, seqs, seqlens, _, _ = _case(seed=41)
    seqlens[2] = 5              # every row but the empty one has a path
    jloss, tloss, nmodcol = _losses(kind, seqs, seqlens, 1.5, rng)
    x = rng.normal(size=lp.shape[:2] + (40 + nmodcol,)).astype(np.float32)
    g = rng.normal(size=len(seqlens)).astype(np.float32)
    want, vjp = jax.vjp(jloss, jnp.asarray(x))
    want_grad = np.asarray(vjp(jnp.asarray(g))[0])

    def port():
        tx = torch.from_numpy(x).requires_grad_()
        out = tloss(tx)
        out.backward(torch.from_numpy(g))
        return out.detach().numpy(), tx.grad.numpy()

    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    counts = _Counts(monkeypatch)
    fused = port()
    assert counts.n == {"crf_fwd": 1, "crf_bwd": 1, "crf_fwd_streams": 0,
                        "crf_bwd_posteriors": 0, "crf_grad_streams": 0}
    if route == "MAX_L":
        monkeypatch.setattr(tcrf, "MAX_L", seqs.shape[1] - 1)
    else:
        monkeypatch.setenv("TAIYAKI_TPU_" + route, "1")
    counts = _Counts(monkeypatch)
    got, got_grad = port()
    assert counts.n == {"crf_fwd": 0, "crf_bwd": 0, "crf_fwd_streams": 1,
                        "crf_bwd_posteriors": 0, "crf_grad_streams": 1}
    for value, grad in ((got, got_grad), fused):
        np.testing.assert_allclose(value, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_grad, fused[1], rtol=1e-5, atol=1e-6)
    assert got[1] == 0.0 and not got_grad[:, 1].any()


@pytest.mark.parametrize("env,shape,want", [
    ({}, (40, 512), False), ({}, (46, 8192), False), ({}, (46, 8193), True),
    ({}, (129, 100), True), ({"TAIYAKI_TPU_NO_SCORE_FUSE": "1"}, (40, 10),
                             True),
    ({"TAIYAKI_TPU_F32_SCORES": "1"}, (40, 10), True),
    ({"TAIYAKI_TPU_NO_SCORE_FUSE": "0", "TAIYAKI_TPU_F32_SCORES": "0"},
     (40, 10), False)])
def test_route_choice(env, shape, want, monkeypatch):
    """The switches count only when set to "1", as the JAX trainer reads
    them; past MAX_S columns or MAX_L positions the streams route is
    taken without a switch."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tff.use_score_streams(*shape) is want
    assert tcrf.MAX_L_STREAMS >= 2 * tcrf.MAX_L


def test_switch_is_read_at_each_loss_call(monkeypatch):
    """The route is fixed when the loss runs forward: a switch set after
    the forward does not change the backward's kernel."""
    lp, seqs, seqlens, _, _ = _case(seed=6)
    monkeypatch.delenv("TAIYAKI_TPU_NO_SCORE_FUSE", raising=False)
    monkeypatch.delenv("TAIYAKI_TPU_F32_SCORES", raising=False)
    counts = _Counts(monkeypatch)
    x = torch.from_numpy(lp).requires_grad_()
    out = tff.crf_flipflop_loss(x, torch.from_numpy(seqs),
                                torch.from_numpy(seqlens))
    monkeypatch.setenv("TAIYAKI_TPU_NO_SCORE_FUSE", "1")
    out.sum().backward()
    assert counts.n == {"crf_fwd": 1, "crf_bwd": 1, "crf_fwd_streams": 0,
                        "crf_bwd_posteriors": 0, "crf_grad_streams": 0}


def test_stream_wrappers_reject_other_devices():
    lp, seqs, seqlens, _, _ = _case(seed=9)
    stay_all, move_all, valid = (_t(a) for a in _streams(
        lp, seqs, seqlens, None, None))
    with pytest.raises(ValueError, match="CUDA"):
        tcrf.crf_fwd_streams(stay_all.to("meta"), move_all.to("meta"),
                             valid.int().to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tcrf.crf_bwd_posteriors(stay_all.to("meta"), move_all.to("meta"),
                                stay_all.to("meta"), valid.int().to("meta"),
                                torch.zeros(len(seqlens), dtype=torch.int32,
                                            device="meta"))
