"""The CRF's score-stream route and logZ under the JAX trainer's mixed
precision (TAIYAKI_TPU_BF16_STREAMS=1 with TAIYAKI_TPU_NO_SCORE_FUSE=1
or TAIYAKI_TPU_F32_SCORES=1; ops/flipflop.py `score_dtype` and
`lattice_dtype`) on the CPU, against the JAX package's mixed precision,
which it runs on the CPU under TAIYAKI_TPU_PALLAS_INTERPRET=1 (B a
multiple of 8), on the same seeded numpy inputs.  The contract, by
switch row: unset, every stream f32 and every call the f32 one;
NO_SCORE_FUSE, bf16 streams and logZ scores, bf16 lattices and
posteriors; F32_SCORES, f32 streams and logZ scores, bf16 lattices and
posteriors (taiyaki_tpu/ops/flipflop.py:99-113, 272-290, 351-369,
595-623).

(a) logZ's mixed instance (rows 2-3: f32 scores, a bf16 lattice and
    bf16 posteriors) through its wrappers against
    `pallas_logz.logz_forward(residual_dtype=bf16)` and
    `logz_backward_posteriors(out_dtype=bf16)` on f32 scores, as
    `_logz_pallas_fwd` / `_bwd` run them under F32_SCORES, and the
    segmented mirrors on the same terms: logZ 1e-3 + 1e-5 |logZ|, the
    lattice and the posteriors equal as bf16 but for at most 1% one bf16
    step apart (`bf16_close`);
(b) the bf16 instances' twins of rows 9-10 against
    `pallas_crf.crf_forward` / `crf_backward_posteriors` in interpret
    mode, with bf16 streams and with f32 streams, both with a bf16
    lattice: score 1e-5 relative, lattice and posteriors `bf16_close`;
    d lp the rounded posteriors summed into their columns, the mod
    column weighted by bf16(fact), against the JAX route's einsums of the
    same posteriors (1e-6);
(c) `crf_flipflop_loss`, `cat_mod_flipflop_loss`, `flipflop_logz` and
    their gradients, and `flipflop_make_trans`, under each switch row
    against the JAX mixed route: within half of the JAX route's own
    distance from its f32 route (the terms of
    tests/test_torch_bf16_scores.py (b)).  cat_mod's mod columns are
    held against the JAX route's scaled by bf16(w)/w: the port weighs a
    bf16 posterior by bf16(fact), as its fused bf16 instance does, where
    the JAX route's einsum weighs it by the f32 fact;
(d) each row's dtypes at the wrappers; the bf16 streams laid out for the
    instance (L padded to a multiple of 8); the route's saved tensors
    about half the f32 route's bytes; the wrappers refuse dtypes of no
    instance;
(e) with the switch unset (or "0") every loss, logZ, gradient and
    make_trans output is bit for bit the f32 twins', and no dtype
    argument reaches a wrapper.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import decode as jdec
from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_crf, pallas_logz
from taiyaki_tpu_torch.ops import crf as tcrf
from taiyaki_tpu_torch.ops import decode as tdec
from taiyaki_tpu_torch.ops import flipflop as tff
from taiyaki_tpu_torch.ops import logz as tlogz
from test_torch_bf16_scores import _close_logz, _dist, _jax_loss, \
    _loss_case, _port_loss, _scores, _states, \
    clean_switches  # noqa: F401 (autouse)
from test_torch_bf16_streams import BF16, F32, SWITCH, _to_jax, _to_torch, \
    bf16_close
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)
from test_torch_crf_streams import _case, _streams, _t

INTERPRET = "TAIYAKI_TPU_PALLAS_INTERPRET"
# the switch rows of the contract: (the score switch, the streams' and
# logZ scores' dtype); lattices and posteriors are bf16 in both
ROWS = {"NO_SCORE_FUSE": ("TAIYAKI_TPU_NO_SCORE_FUSE", BF16),
        "F32_SCORES": ("TAIYAKI_TPU_F32_SCORES", F32)}


# -- (a) logZ's mixed instance against the TPU kernels ------------------------

@pytest.mark.parametrize("nbase,T,B", [(4, 37, 8), (2, 50, 8), (1, 20, 8)])
def test_logz_mixed_instance_matches_pallas_kernels(nbase, T, B):
    """f32 scores, a bf16 lattice and bf16 posteriors, through the
    wrappers (their plain twins here); the posteriors on the TPU kernel's
    own lattice."""
    s32 = torch.from_numpy(_scores(T, B, nbase, seed=T + nbase))
    nff, S = 2 * nbase, s32.shape[2]
    sp = jff._logz_pad_scores(_to_jax(s32), 8, dtype=jnp.float32)
    _, zj, latj = pallas_logz.logz_forward(sp, nbase, block_t=8,
                                           interpret=True,
                                           residual_dtype=jnp.bfloat16)
    postj = pallas_logz.logz_backward_posteriors(
        sp, latj, nbase, block_t=8, interpret=True, out_dtype=jnp.bfloat16)
    latj, postj = _to_torch(latj[:T, :, :nff]), _to_torch(postj[:T, :, :S])
    f, z, lat = tlogz.logz_fwd(s32, lattice_dtype=BF16)
    assert f.dtype == z.dtype == F32 and lat.dtype == BF16
    _close_logz(z.numpy(), np.asarray(zj))
    bf16_close(_states(lat), latj, atol=0.0)
    lat_j = latj.float().masked_fill(latj.float() < -1e29,
                                     -math.inf).to(BF16)
    post = tlogz.logz_posteriors(s32, lat_j, out_dtype=BF16)
    assert post.dtype == BF16
    bf16_close(post, postj, atol=0.0)
    # the kernels' segmented mirrors round at the same points
    f1, z1, lat1 = tlogz.logz_fwd_segmented(s32, nbase, 7,
                                            lattice_dtype=BF16)
    assert lat1.dtype == BF16
    _close_logz(z1.numpy(), z.numpy())
    bf16_close(_states(lat1), _states(lat), atol=0.0)
    torch.testing.assert_close(f1, f, rtol=0, atol=1e-4)
    seg = tlogz.logz_posteriors_segmented(s32, lat_j, nbase, 7,
                                          out_dtype=BF16)
    assert seg.dtype == BF16
    bf16_close(seg, post, atol=0.0)


# -- (b) rows 9-10's bf16 instances against the TPU kernels -------------------

@pytest.mark.parametrize("sdt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("nmod", [0, 3])
def test_stream_twins_match_unfused_pallas_kernels(nmod, sdt):
    """On the Pallas kernels' own padded inputs (L to 128 lanes, T to the
    block), the streams stored as the JAX route stores them (`sdt`), the
    lattice and the posteriors bf16; the backwards on the TPU kernel's
    lattice."""
    T, bt = 12, 8
    lp, seqs, seqlens, mm, mf = _case(T=T, B=8, nmod=nmod, seed=30 + nmod)
    L, S = seqs.shape[1], lp.shape[2]
    stay_all, move_all, valid = _streams(lp, seqs, seqlens, mm, mf)
    stay_p, move_p, valid_p = jff._pallas_lattice_inputs(
        stay_all, move_all, valid, bt,
        dtype=jnp.bfloat16 if sdt == BF16 else jnp.float32)
    last = jnp.clip(jnp.asarray(seqlens) - 1, 0, L - 1)
    fwd, score, lattice = pallas_crf.crf_forward(
        stay_p, move_p, valid_p, block_t=bt, interpret=True,
        residual_dtype=jnp.bfloat16)
    post_s, post_m = pallas_crf.crf_backward_posteriors(
        stay_p, move_p, lattice, valid_p, last[:, None].astype(jnp.int32),
        block_t=4, interpret=True, out_dtype=jnp.bfloat16)
    want_score = np.asarray(score + jnp.take_along_axis(
        fwd[:, :L], last[:, None], axis=1)[:, 0])
    has_path = np.array([b not in (1, 2) for b in range(len(seqlens))])
    live = _t(valid)[None]
    t_last = _t(last).int()

    stay, move = _to_torch(stay_p), _to_torch(move_p)
    assert stay.dtype == move.dtype == sdt
    vp = _t(valid_p).int()
    g_fwd, g_score, g_lat = tcrf.crf_fwd_streams(stay, move, vp,
                                                 lattice_dtype=BF16)
    assert g_lat.dtype == BF16 and g_score.dtype == g_fwd.dtype == F32
    got_score = (g_score + g_fwd.gather(1, t_last.long()[:, None])[:, 0]
                 ).numpy()
    np.testing.assert_allclose(got_score[has_path], want_score[has_path],
                               rtol=1e-5, atol=1e-5)
    j_lat = _to_torch(lattice)

    def on_live(x):
        return torch.where(live, x[:T, :, :L].float(), 0.0).to(BF16)
    bf16_close(on_live(g_lat), on_live(j_lat), atol=0.0)
    g_ps, g_pm = tcrf.crf_bwd_posteriors(stay, move, j_lat, vp, t_last)
    assert g_ps.dtype == g_pm.dtype == BF16
    for got, want in ((g_ps, post_s), (g_pm, post_m)):
        bf16_close(on_live(got), on_live(_to_torch(want)), atol=0.0)
    # no path, or no positions: all-zero posteriors
    for post in (g_ps, g_pm):
        assert not post[:, 1].float().any() and not post[:, 2].float().any()

    # d lp: these posteriors summed into their columns, the mod column
    # weighted by bf16(fact); the JAX route's einsums of the same bf16
    # posteriors with selectors of the rounded factors
    tstay, tmove = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    idx = tff._lattice_inputs(
        tstay, tmove, torch.from_numpy(seqlens), S,
        None if mm is None else torch.from_numpy(mm),
        None if mf is None else torch.from_numpy(mf), width=stay.shape[2])
    sidx, midx, mmidx, mfact, _, _ = idx
    grad = tcrf.crf_grad_streams(stay, move, j_lat, vp, t_last, sidx, midx,
                                 mmidx, mfact, S)
    assert grad.dtype == F32
    jstay, jmove = jff.make_seq_indices(jnp.asarray(seqs), 4)
    mf16 = None if mf is None else _to_jax(torch.from_numpy(mf).to(BF16))
    sel_stay, sel_move = jff._make_selectors(
        jstay, jmove, None if mm is None else jnp.asarray(mm),
        None if mf is None else mf16.astype(jnp.float32), S)
    want = (jnp.einsum("tbl,bls->tbs", post_s[:T, :, :L], sel_stay,
                       preferred_element_type=jnp.float32)
            + jnp.einsum("tbl,bls->tbs", post_m[:T, :, :L - 1], sel_move,
                         preferred_element_type=jnp.float32))
    torch.testing.assert_close(grad[:T], _t(want), rtol=0, atol=1e-6)


# -- (c) the route under each switch row against the JAX mixed route ---------

def _mod_scale(weights, S):
    """[S] factors of d lp's columns: bf16(w)/w on each cat_mod column
    (after the 40 transition columns), 1 elsewhere."""
    w = torch.from_numpy(np.asarray(weights, np.float32))
    scale = np.ones(S, np.float32)
    scale[S - len(weights):] = (w.to(BF16).float() / w).numpy()
    return scale


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("kind", ["crf", "cat_mod", "logz"])
def test_loss_within_the_jax_mixed_routes_distance(kind, row, monkeypatch):
    env = ROWS[row][0]
    jfn, tfn, args, targs = _loss_case(kind, seed=3)
    targs = (args[0], targs, args[2])
    j32 = _jax_loss(jfn, args, monkeypatch, False)
    t32 = _port_loss(tfn, targs, monkeypatch, False)
    monkeypatch.setenv(env, "1")
    j16 = _jax_loss(jfn, args, monkeypatch, True)
    t16 = _port_loss(tfn, targs, monkeypatch, True)
    if kind == "cat_mod":
        scale = _mod_scale(args[1][4], args[0].shape[2])
        raw = j16[1]
        j16 = (j16[0], raw * scale)
        # the factor's rounding is what moves the mod columns
        mods = scale != 1
        assert _dist(t16[1][..., mods], j16[1][..., mods]) < _dist(
            t16[1][..., mods], raw[..., mods])
    for i, what in enumerate(("value", "gradient")):
        assert _dist(t32[i], j32[i]) <= 1e-4 * max(
            np.abs(j32[i]).max(), 1.0), what
        route = _dist(j16[i], j32[i])
        if route == 0:
            # the CRF's value on f32 streams: the f32 forward in both
            # packages (the bf16 lattice is a gradient-only residual)
            assert (what, kind, row) in (("value", "crf", "F32_SCORES"),
                                         ("value", "cat_mod", "F32_SCORES"))
            assert np.array_equal(t16[i], t32[i])
            continue
        assert _dist(t16[i], j16[i]) <= 0.5 * route, (
            what, _dist(t16[i], j16[i]), route)
        assert _dist(t16[i], t32[i]) <= 2 * route, (
            what, _dist(t16[i], t32[i]), route)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_make_trans_within_the_jax_mixed_routes_distance(row, monkeypatch):
    """The basecall's posteriors (its CLIs set TAIYAKI_TPU_F32_SCORES=1,
    so the F32_SCORES row is the basecall's under the switch)."""
    env = ROWS[row][0]
    x = _scores(60, 8, 4, seed=7)
    j32 = np.asarray(jdec.flipflop_make_trans(jnp.asarray(x)))
    t32 = tdec.flipflop_make_trans(torch.from_numpy(x)).numpy()
    monkeypatch.setenv(env, "1")
    monkeypatch.setenv(INTERPRET, "1")
    j16 = np.asarray(jdec.flipflop_make_trans(jnp.asarray(x)))
    monkeypatch.delenv(INTERPRET)
    monkeypatch.setenv(SWITCH, "1")
    t16 = tdec.flipflop_make_trans(torch.from_numpy(x))
    assert t16.dtype == F32
    t16 = t16.numpy()
    route = _dist(j16, j32)
    assert route > 0
    assert _dist(t16, j16) <= 0.5 * route, (_dist(t16, j16), route)
    assert _dist(t32, j32) <= 1e-5
    # bf16 posteriors widened
    assert np.array_equal(t16, t16.astype(jnp.bfloat16).astype(np.float32))


# -- (d) dtypes, layout, saved bytes, refusals --------------------------------

def _recording(monkeypatch, calls):
    """Record each wrapper's name, the dtypes and shapes of its floating
    tensors, and its keyword arguments, in ops.flipflop's and ops.decode's
    namespaces."""
    def wrap(mod, name):
        real = getattr(mod, name)

        def spy(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)
                  and a.is_floating_point()]
            calls.append((name, tuple(t.dtype for t in ts),
                          tuple(tuple(t.shape) for t in ts), dict(kw)))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    for name in ("crf_fwd", "crf_bwd", "crf_fwd_streams",
                 "crf_grad_streams"):
        wrap(tcrf, name)
    for name in ("logz_fwd", "logz_posteriors"):
        wrap(tff, name)


def _route(lp, seqs, seqlens, scores):
    """(loss, d loss / d lp, d loss / d scores, make_trans) of the CRF
    loss and logZ on the same scores."""
    tlp = torch.from_numpy(lp).requires_grad_()
    ts = torch.from_numpy(scores).requires_grad_()
    loss = (tff.crf_flipflop_loss(tlp, torch.from_numpy(seqs),
                                  torch.from_numpy(seqlens)).sum()
            + tff.flipflop_logz(ts).sum())
    grads = torch.autograd.grad(loss, (tlp, ts))
    return (loss.detach(),) + grads + (
        tdec.flipflop_make_trans(torch.from_numpy(scores)),)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_switch_rows_at_the_wrappers(row, monkeypatch):
    """The streams, lattices and posteriors of each row at the wrappers,
    training (loss, logZ) and basecall (make_trans); bf16 streams padded
    to a multiple of 8 positions, f32 ones not."""
    env, sdt = ROWS[row]
    lp, seqs, seqlens, _, _ = _case(T=20, B=8, L=14, seed=40)
    seqlens[2] = 9
    scores = _scores(20, 8, 4, seed=41)
    calls = []
    _recording(monkeypatch, calls)
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setenv(env, "1")
    out = _route(lp, seqs, seqlens, scores)
    assert all(o.dtype == F32 for o in out)
    names = [c[0] for c in calls]
    assert sorted(names) == sorted(["crf_fwd_streams", "crf_grad_streams"]
                                   + ["logz_fwd", "logz_posteriors"] * 2)
    width = 16 if sdt == BF16 else 14
    for name, dtypes, shapes, kw in calls:
        if name == "crf_fwd_streams":
            assert dtypes == (sdt, sdt) and kw["lattice_dtype"] == BF16
            assert shapes[0] == (20, 8, width)
        elif name == "crf_grad_streams":
            # stay, move, the lattice, mfact
            assert dtypes == (sdt, sdt, BF16, F32)
            assert shapes[2] == (20, 8, width)
        elif name == "logz_fwd":
            assert dtypes == (sdt,) and kw["lattice_dtype"] == BF16
        else:
            assert dtypes == (sdt, BF16) and kw["out_dtype"] == BF16


def _saved_bytes(fn):
    """The bytes of the floating tensors autograd saves in fn()."""
    total = [0]

    def pack(t):
        if t.is_floating_point():
            total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


def test_bf16_streams_halve_the_saved_bytes(monkeypatch):
    """The streams route's saved streams and lattice in bf16 (the JAX
    route's residuals) against the f32 route's, at L a multiple of 8."""
    lp, seqs, seqlens, _, _ = _case(T=30, B=8, L=40, seed=42)
    monkeypatch.setenv("TAIYAKI_TPU_NO_SCORE_FUSE", "1")

    def loss():
        tff.crf_flipflop_loss(torch.from_numpy(lp).requires_grad_(),
                              torch.from_numpy(seqs),
                              torch.from_numpy(seqlens)).sum()
    f32 = _saved_bytes(loss)
    monkeypatch.setenv(SWITCH, "1")
    bf16 = _saved_bytes(loss)
    assert 0 < bf16 <= 0.55 * f32, (bf16, f32)


def test_stream_wrappers_refuse_dtypes_of_no_instance():
    lp, seqs, seqlens, _, _ = _case(T=6, B=8, seed=43)
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    sidx, midx, mmidx, mfact, valid, last = tff._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), lp.shape[2])
    s32, m32 = tff._select_streams(torch.from_numpy(lp), sidx, midx, None,
                                   None)
    s16, m16 = s32.to(BF16), m32.to(BF16)
    with pytest.raises(ValueError, match="no instance"):
        tcrf.crf_fwd_streams(s16, m16, valid, lattice_dtype=F32)
    with pytest.raises(ValueError, match="no instance"):
        tcrf.crf_fwd_streams(s32.half(), m32.half(), valid)
    _, _, lat32 = tcrf.crf_fwd_streams(s32, m32, valid)
    _, _, lat16 = tcrf.crf_fwd_streams(s16, m16, valid)
    assert lat32.dtype == F32 and lat16.dtype == BF16
    with pytest.raises(ValueError, match="no instance"):
        tcrf.crf_bwd_posteriors(s16, m16, lat32, valid, last)
    with pytest.raises(ValueError, match="no instance"):
        tcrf.crf_grad_streams(s16, m16, lat32, valid, last, sidx, midx,
                              mmidx, mfact, lp.shape[2])
    # f32 streams with a bf16 lattice: the mixed instance
    p = tcrf.crf_bwd_posteriors(s32, m32, lat16, valid, last)
    assert p[0].dtype == p[1].dtype == BF16


# -- (e) the switch unset: the f32 calls as they were -------------------------

@pytest.mark.parametrize("value", [None, "0"])
def test_switch_unset_is_the_f32_route(value, monkeypatch):
    """With the switch unset (or "0") and TAIYAKI_TPU_NO_SCORE_FUSE=1 the
    loss takes the streams route in f32: no dtype argument at any wrapper,
    every tensor f32 and unpadded, and the loss, its gradients and
    make_trans bit for bit the f32 twins' called without one."""
    lp, seqs, seqlens, _, _ = _case(T=20, B=8, L=14, seed=44)
    seqlens[2] = 9
    scores = _scores(20, 8, 4, seed=45)
    monkeypatch.setenv("TAIYAKI_TPU_NO_SCORE_FUSE", "1")
    if value is not None:
        monkeypatch.setenv(SWITCH, value)
    calls = []
    _recording(monkeypatch, calls)
    got = _route(lp, seqs, seqlens, scores)
    assert {c[0] for c in calls} == {"crf_fwd_streams", "crf_grad_streams",
                                     "logz_fwd", "logz_posteriors"}
    for name, dtypes, shapes, kw in calls:
        assert set(dtypes) == {F32}, name
        assert not {"lattice_dtype", "out_dtype", "score_dtype"} & set(kw)
    # the twins, as the route calls them
    T, S = lp.shape[0], lp.shape[2]
    stay, move = tff.make_seq_indices(torch.from_numpy(seqs), 4)
    sidx, midx, mmidx, mfact, valid, last = tff._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), S)
    t_lp = torch.from_numpy(lp)
    s32, m32 = tff._select_streams(t_lp, sidx, midx, None, None)
    fwd, score, lat = tcrf.crf_fwd_streams_plain(s32, m32, valid)
    score = score + fwd.gather(1, last.long()[:, None])[:, 0]
    s = torch.from_numpy(scores)
    _, z, zlat = tlogz.logz_fwd_plain(s, 4)
    t_len = torch.from_numpy(seqlens)
    cost = torch.where(t_len > 0, -score / T, torch.zeros_like(score))
    assert torch.equal(got[0], cost.sum() + (z + math.log(4)).sum())
    post = tcrf.crf_grad_streams_plain(s32, m32, lat, valid, last, sidx,
                                       midx, mmidx, mfact, S)
    gm = (t_len > 0).float()
    assert torch.equal(got[1], (-post / T) * gm[None, :, None])
    zpost = tlogz.logz_posteriors_plain(s, zlat, 4)
    assert torch.equal(got[2], zpost)
    assert torch.equal(got[3], zpost)
