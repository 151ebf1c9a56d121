"""The LSTM forward with backward residuals (kernel 1, emit="acts") and the
LSTM backward (kernel 4, lstm_bwd_acts) of the port, as plain twins on the
CPU, against the JAX package: the TPU kernels in interpret mode (f32
streams, time padded to their block and sliced back) and jax.vjp of the
CPU lax.scan layer.  Same seeded numpy inputs.

Tolerances: 1e-5 (f32, the same arithmetic in another order) for the
forward residuals; for gradients 1e-5 of each output's largest value (sums
over T*B rows in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch.ops import lstm as tlstm
from taiyaki_tpu_torch.ops import rnn as trnn

BT = 8    # the TPU kernels' time block


def _inputs(T, B, D, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (0.4 * rng.normal(size=(4 * H, D))).astype(np.float32)
    b = rng.normal(size=(4 * H,)).astype(np.float32)
    sW = (0.4 * rng.normal(size=(4 * H, H))).astype(np.float32)
    dh = rng.normal(size=(T, B, H)).astype(np.float32)
    return x, iW, b, sW, dh


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [3, 16])
def test_acts_twin_matches_pallas_kernel(B, reverse):
    T, D, H = 13, 5, 8
    x, iW, b, sW, _ = _inputs(T, B, D, H, seed=B)
    h, c, acts, tc = pallas_rnn.lstm_fused_fwd(
        jrnn._pad_time(jnp.asarray(x), BT), jnp.asarray(iW), jnp.asarray(b),
        jnp.asarray(sW), block_t=BT, interpret=True, reverse=reverse,
        true_len=T, emit="acts")
    got = tlstm.lstm_fwd(*map(torch.from_numpy, (x, iW, b, sW)),
                         reverse=reverse, emit="acts")
    for g, w in zip(got, (h, c, acts, tc)):
        _close(g.numpy(), np.asarray(w)[:T])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [3, 16])
def test_bwd_twin_matches_pallas_kernel(B, reverse):
    """Kernel 4's twin against lstm_bwd_acts in interpret mode: d_x, and
    the weight gradients summed over the TPU kernel's batch-tile
    partials."""
    T, D, H = 13, 5, 8
    x, iW, b, sW, dh = _inputs(T, B, D, H, seed=10 + B)
    tx, tiW, tb, tsW, tdh = map(torch.from_numpy, (x, iW, b, sW, dh))
    h, c, acts, tc = tlstm.lstm_fwd(tx, tiW, tb, tsW, reverse=reverse,
                                    emit="acts")
    c_prev = tlstm.prev_state(c, reverse)
    got = tlstm.lstm_bwd_acts(tdh, acts, tc, c_prev, h, tx, tsW, tiW,
                              reverse=reverse)
    pad = lambda a: jrnn._pad_time(jnp.asarray(np.asarray(a)), BT)
    d_x, dsw, diw, db = pallas_rnn.lstm_bwd_acts(
        pad(dh), pad(acts), pad(tc), pad(c_prev), pad(h), pad(x),
        jnp.asarray(sW), jnp.asarray(iW), block_t=BT, interpret=True,
        reverse=reverse, dx_dtype=jnp.float32, true_len=T)
    _close(got[0].numpy(), np.asarray(d_x)[:T])
    for g, w in zip(got[1:], (dsw, diw, db)):
        _close(g.sum(0).numpy(), np.asarray(w).sum(0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [3, 16])
def test_layer_gradient_matches_jax_vjp(B, reverse):
    """lstm_layer as an autograd Function against jax.vjp of the JAX
    package's lstm_layer on the CPU (its f32 scan path)."""
    T, D, H = 13, 5, 8
    x, iW, b, sW, dh = _inputs(T, B, D, H, seed=20 + B)
    h, vjp = jax.vjp(lambda *a: jrnn.lstm_layer(*a, reverse=reverse),
                     *map(jnp.asarray, (x, iW, b, sW)))
    want = vjp(jnp.asarray(dh))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, iW, b, sW)]
    got_h = trnn.lstm_layer(*args, reverse=reverse)
    got_h.backward(torch.from_numpy(dh))
    _close(got_h.detach().numpy(), h)
    for a, w in zip(args, want):
        _close(a.grad.numpy(), w)


def test_layer_without_grad_takes_the_inference_kernel():
    """With no grad the layer runs emit=None (h only), under grad the
    autograd Function; both give the same h."""
    x, iW, b, sW, _ = _inputs(9, 4, 3, 5, seed=3)
    args = [torch.from_numpy(a) for a in (x, iW, b, sW)]
    with torch.no_grad():
        plain = trnn.lstm_layer(*args, reverse=True)
    assert plain.grad_fn is None
    graded = trnn.lstm_layer(*[a.clone().requires_grad_() for a in args],
                             reverse=True)
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())


def test_prev_state_matches_jax():
    c = np.random.default_rng(0).normal(size=(6, 2, 3)).astype(np.float32)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            tlstm.prev_state(torch.from_numpy(c), reverse).numpy(),
            np.asarray(jrnn._prev_state(jnp.asarray(c), reverse)))


def test_unknown_emit_raises():
    x, iW, b, sW, _ = _inputs(4, 2, 3, 4, seed=1)
    with pytest.raises(ValueError, match="emit"):
        tlstm.lstm_fwd(*map(torch.from_numpy, (x, iW, b, sW)), emit="pre")
