"""The GRU forward (kernel 7, gru_fused_fwd, with and without its gate
streams), the recomputing GRU backward (kernel 8, gru_bwd_recompute) and
the GRU backward from stored gate streams (kernel 13, gru_bwd_fusedw) of
the port, as plain twins on the CPU, against the JAX package: the TPU
kernels in interpret mode (time padded to their block of 8 with true_len,
sliced back) and the CPU lax.scan layer with jax.vjp.  Same seeded numpy inputs, T=19, B=24, D=12
and H=16 (the shape of tests/test_pallas_rnn.py:517-555) or H=17.

Tolerances: f32, atol 1e-5 and rtol 1e-4 (those of the JAX package's own
GRU tests); the weight gradients, sums over T*B rows in another order,
atol 1e-4 as there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch.ops import gru as tgru
from taiyaki_tpu_torch.ops import lstm as tlstm
from taiyaki_tpu_torch.ops import rnn as trnn

BT = 8    # the TPU kernels' time block
T, B, D = 19, 24, 12


def _inputs(H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (0.3 * rng.normal(size=(3 * H, D))).astype(np.float32)
    b = (0.3 * rng.normal(size=(3 * H,))).astype(np.float32)
    sW = (0.3 * rng.normal(size=(3 * H, H))).astype(np.float32)
    dh = rng.normal(size=(T, B, H)).astype(np.float32)
    return x, iW, b, sW, dh


def _close(got, want, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def _pad(a):
    return jrnn._pad_time(jnp.asarray(np.asarray(a)), BT)


def _vjp(x, iW, b, sW, dh, reverse):
    """h and (d_x, d_iW, d_b, d_sW) of the JAX layer's CPU scan path."""
    h, vjp = jax.vjp(lambda *a: jrnn.gru_layer(*a, reverse=reverse),
                     *map(jnp.asarray, (x, iW, b, sW)))
    return h, vjp(jnp.asarray(dh))


CASES = [(H, reverse) for H in (16, 17) for reverse in (False, True)]


@pytest.mark.parametrize("H,reverse", CASES)
def test_fwd_twin_matches_cpu_scan(H, reverse):
    x, iW, b, sW, dh = _inputs(H, seed=H)
    want, _ = _vjp(x, iW, b, sW, dh, reverse)
    got = tgru.gru_fwd(*map(torch.from_numpy, (x, iW, b, sW)),
                       reverse=reverse)
    _close(got.numpy(), want)


@pytest.mark.parametrize("H,reverse", CASES)
def test_fwd_twin_matches_pallas_kernel(H, reverse):
    x, iW, b, sW, _ = _inputs(H, seed=10 + H)
    h, = pallas_rnn.gru_fused_fwd(
        _pad(x), jnp.asarray(iW), jnp.asarray(b), jnp.asarray(sW),
        block_t=BT, interpret=True, reverse=reverse, true_len=T,
        emit_residuals=False)
    got = tgru.gru_fwd(*map(torch.from_numpy, (x, iW, b, sW)),
                       reverse=reverse)
    _close(got.numpy(), np.asarray(h)[:T])


@pytest.mark.parametrize("H,reverse", CASES)
def test_bwd_twin_matches_pallas_kernel_and_vjp(H, reverse):
    """Kernel 8's twin: d_x and the summed weight-gradient partials
    against gru_bwd_recompute in interpret mode and against jax.vjp."""
    x, iW, b, sW, dh = _inputs(H, seed=20 + H)
    h, (dx_v, diw_v, db_v, dsw_v) = _vjp(x, iW, b, sW, dh, reverse)
    tx, tiW, tb, tsW, tdh = map(torch.from_numpy, (x, iW, b, sW, dh))
    th = tgru.gru_fwd(tx, tiW, tb, tsW, reverse=reverse)
    got = tgru.gru_bwd_recompute(tdh, th, tx, tsW, tiW, tb, reverse=reverse)
    d_x, dsw, diw, db = pallas_rnn.gru_bwd_recompute(
        _pad(dh), _pad(th), _pad(x), jnp.asarray(sW), jnp.asarray(iW),
        jnp.asarray(b), block_t=BT, interpret=True, reverse=reverse,
        true_len=T)
    _close(got[0].numpy(), np.asarray(d_x)[:T])
    _close(got[0].numpy(), dx_v)
    for g, w, v in zip(got[1:], (dsw, diw, db), (dsw_v, diw_v, db_v)):
        _close(g.sum(0).numpy(), np.asarray(w).sum(0), atol=1e-4)
        _close(g.sum(0).numpy(), v, atol=1e-4)


@pytest.mark.parametrize("H,reverse", CASES)
def test_layer_gradient_matches_jax_vjp(H, reverse):
    """gru_layer as an autograd Function against jax.vjp of the JAX
    package's gru_layer on the CPU (its f32 scan path)."""
    x, iW, b, sW, dh = _inputs(H, seed=30 + H)
    h, want = _vjp(x, iW, b, sW, dh, reverse)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, iW, b, sW)]
    got_h = trnn.gru_layer(*args, reverse=reverse)
    got_h.backward(torch.from_numpy(dh))
    _close(got_h.detach().numpy(), h)
    for a, w in zip(args, want):
        _close(a.grad.numpy(), w, atol=1e-4)


def test_layer_without_grad_takes_the_forward_kernel_alone(monkeypatch):
    """With no grad the layer runs gru_fwd and nothing else; under grad
    the autograd Function; both give the same h.  Under
    TAIYAKI_TPU_NO_RECOMPUTE=1 (the stored gate streams, kernel 13's
    twin) the layer gives the recomputing path's h and gradients."""
    x, iW, b, sW, dh = _inputs(5, seed=3)
    args = [torch.from_numpy(a) for a in (x, iW, b, sW)]
    with torch.no_grad():
        plain = trnn.gru_layer(*args, reverse=True)
    assert plain.grad_fn is None
    graded = trnn.gru_layer(*[a.clone().requires_grad_() for a in args],
                            reverse=True)
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())
    res = {}
    for stored in (False, True):
        if stored:
            monkeypatch.setenv("TAIYAKI_TPU_NO_RECOMPUTE", "1")
        leaves = [a.clone().requires_grad_() for a in args]
        h = trnn.gru_layer(*leaves)
        h.backward(torch.from_numpy(dh))
        res[stored] = [h.detach()] + [a.grad for a in leaves]
    assert torch.equal(res[True][0], res[False][0])
    for g, w in zip(res[True][1:], res[False][1:]):
        _close(g.numpy(), w.numpy(), atol=1e-4)


@pytest.mark.parametrize("H,reverse", CASES)
def test_fwd_residuals_twin_matches_pallas_kernel(H, reverse):
    """emit_residuals=True against gru_fused_fwd's (h, gh, gx)."""
    x, iW, b, sW, _ = _inputs(H, seed=40 + H)
    want = pallas_rnn.gru_fused_fwd(
        _pad(x), jnp.asarray(iW), jnp.asarray(b), jnp.asarray(sW),
        block_t=BT, interpret=True, reverse=reverse, true_len=T,
        emit_residuals=True)
    got = tgru.gru_fwd(*map(torch.from_numpy, (x, iW, b, sW)),
                       reverse=reverse, emit_residuals=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w)[:T])


@pytest.mark.parametrize("H,reverse", CASES)
def test_fusedw_twin_matches_pallas_kernel_and_vjp(H, reverse):
    """Kernel 13's twin: d_x and the summed weight-gradient partials
    against gru_bwd_fusedw in interpret mode and against jax.vjp."""
    x, iW, b, sW, dh = _inputs(H, seed=50 + H)
    _, (dx_v, diw_v, db_v, dsw_v) = _vjp(x, iW, b, sW, dh, reverse)
    tx, tiW, tb, tsW, tdh = map(torch.from_numpy, (x, iW, b, sW, dh))
    th, gh, gx = tgru.gru_fwd(tx, tiW, tb, tsW, reverse=reverse,
                              emit_residuals=True)
    h_prev = tlstm.prev_state(th, reverse)
    got = tgru.gru_bwd_fusedw(tdh, gx, gh, h_prev, tx, tsW, tiW,
                              reverse=reverse)
    d_x, dsw, diw, db = pallas_rnn.gru_bwd_fusedw(
        _pad(dh), _pad(gx), _pad(gh), _pad(h_prev), _pad(x),
        jnp.asarray(sW), jnp.asarray(iW), block_t=BT, interpret=True,
        reverse=reverse, true_len=T)
    _close(got[0].numpy(), np.asarray(d_x)[:T])
    _close(got[0].numpy(), dx_v)
    for g, w, v in zip(got[1:], (dsw, diw, db), (dsw_v, diw_v, db_v)):
        _close(g.sum(0).numpy(), np.asarray(w).sum(0), atol=1e-4)
        _close(g.sum(0).numpy(), v, atol=1e-4)


@pytest.mark.parametrize("H,reverse", CASES)
def test_stored_layer_gradient_matches_jax_vjp(H, reverse, monkeypatch):
    """gru_layer under TAIYAKI_TPU_NO_RECOMPUTE=1 against jax.vjp of the
    JAX package's gru_layer on the CPU."""
    monkeypatch.setenv("TAIYAKI_TPU_NO_RECOMPUTE", "1")
    x, iW, b, sW, dh = _inputs(H, seed=60 + H)
    h, want = _vjp(x, iW, b, sW, dh, reverse)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, iW, b, sW)]
    got_h = trnn.gru_layer(*args, reverse=reverse)
    got_h.backward(torch.from_numpy(dh))
    _close(got_h.detach().numpy(), h)
    for a, w in zip(args, want):
        _close(a.grad.numpy(), w, atol=1e-4)


def test_grumod_without_bias_trains_no_bias():
    """GruMod(has_bias=False) keeps a zero b that gets no gradient."""
    from taiyaki_tpu import layers as jlayers
    from taiyaki_tpu_torch import layers as tlayers
    from taiyaki_tpu_torch.convert import load_jax_params
    rng = np.random.default_rng(9)
    tl = tlayers.GruMod(5, 4, has_bias=False)
    load_jax_params(tl, jlayers.GruMod(5, 4, has_bias=False).init(rng))
    assert not tl.b.any()
    x = torch.from_numpy(rng.normal(size=(20, 3, 5)).astype(np.float32))
    tl(x).sum().backward()
    assert tl.b.grad is None
    assert tl.iW.grad is not None and tl.sW.grad is not None
