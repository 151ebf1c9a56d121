"""The recurrences on given input gates, `lstm_scan` and `gru_scan`
(kernels 14-17: lstm_fwd, lstm_bwd, gru_fwd, gru_bwd of
taiyaki_tpu/ops/pallas_rnn.py), of the port on the CPU against the JAX
package, on the same seeded numpy inputs:

- the plain twins of the four kernels against the TPU kernels in
  interpret mode (block_t 8, f32 residuals, T a multiple of the block, B
  of 8), both directions, the backwards with and without iW;
- the port's `lstm_scan` / `gru_scan`, values and (d gates_x, d_sW),
  against jax.vjp of the JAX package's on its CPU scan path (odd T and
  B), and under TAIYAKI_TPU_PALLAS_INTERPRET=1 (B=8), where the JAX
  package runs the Pallas kernels and stores their residuals in bf16;
- `lstm_scan(x . iW^T + b)` against `lstm_layer(x)` in the port, and
  the same for the GRU.

Tolerances: forwards rtol 1e-5 / atol 1e-6, backwards rtol 1e-4 / atol
1e-5 (those of tests/test_pallas_rnn.py); d_sW, a sum over T*B rows in
another order, atol 1e-4.  Against the JAX package's bf16 residuals
(pre and c, or gh, rounded to 8 bits of mantissa, relative error up to
2^-9 each): h, computed in f32, as above; the gradients 5e-3 of each
one's largest value (1.8e-3 at most seen).
"""

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
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

BT = 8          # the TPU kernels' time block
H, D = 16, 12



def _inputs(G, T, B, seed):
    """gates_x [T, B, G*H], sW [G*H, H], dh [T, B, H], iW [G*H, D]."""
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(T, B, G * H)).astype(np.float32)
    sW = (0.3 * rng.normal(size=(G * H, H))).astype(np.float32)
    dh = rng.normal(size=(T, B, H)).astype(np.float32)
    iW = (0.3 * rng.normal(size=(G * H, D))).astype(np.float32)
    return gx, sW, dh, iW


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


DIRS = [False, True]
BWD_CASES = [(r, with_iw) for r in DIRS for with_iw in (False, True)]


@pytest.mark.parametrize("reverse", DIRS)
def test_lstm_scan_fwd_twin_matches_pallas_kernel(reverse):
    """Kernel 14's twin: h, c and pre against pallas_rnn.lstm_fwd."""
    gx, sW, _, _ = _inputs(4, 24, 8, seed=1)
    want = pallas_rnn.lstm_fwd(*_j(gx, sW), block_t=BT, interpret=True,
                               reverse=reverse)
    got = tlstm.lstm_scan_fwd(*_t(gx, sW), reverse=reverse, residuals=True)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5, 1e-6)
    h = tlstm.lstm_scan_fwd(*_t(gx, sW), reverse=reverse)
    assert torch.equal(h, got[0])


@pytest.mark.parametrize("reverse,with_iw", BWD_CASES)
def test_lstm_scan_bwd_twin_matches_pallas_kernel(reverse, with_iw):
    """Kernel 15's twin: dpre (and d_x) against pallas_rnn.lstm_bwd on the
    forward's own residuals."""
    gx, sW, dh, iW = _inputs(4, 24, 8, seed=2)
    h, c, pre = tlstm.lstm_scan_fwd_plain(*_t(gx, sW), reverse=reverse,
                                          residuals=True)
    c_prev = tlstm.prev_state(c, reverse)
    iw = iW if with_iw else None
    want = pallas_rnn.lstm_bwd(
        *_j(dh, pre.numpy(), c.numpy(), c_prev.numpy(), sW), block_t=BT,
        interpret=True, reverse=reverse,
        iW=None if iw is None else jnp.asarray(iw))
    got = tlstm.lstm_scan_bwd(*_t(dh), pre, c, c_prev, *_t(sW),
                              reverse=reverse,
                              iW=None if iw is None else _t(iw)[0])
    if not with_iw:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4, 1e-5)


@pytest.mark.parametrize("reverse", DIRS)
def test_gru_scan_fwd_twin_matches_pallas_kernel(reverse):
    """Kernel 16's twin: h and gh against pallas_rnn.gru_fwd."""
    gx, sW, _, _ = _inputs(3, 24, 8, seed=3)
    want = pallas_rnn.gru_fwd(*_j(gx, sW), block_t=BT, interpret=True,
                              reverse=reverse)
    got = tgru.gru_scan_fwd(*_t(gx, sW), reverse=reverse, residuals=True)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5, 1e-6)
    h = tgru.gru_scan_fwd(*_t(gx, sW), reverse=reverse)
    assert torch.equal(h, got[0])


@pytest.mark.parametrize("reverse,with_iw", BWD_CASES)
def test_gru_scan_bwd_twin_matches_pallas_kernel(reverse, with_iw):
    """Kernel 17's twin: dgx, dgh (and d_x) against pallas_rnn.gru_bwd on
    the forward's own residuals."""
    gx, sW, dh, iW = _inputs(3, 24, 8, seed=4)
    h, gh = tgru.gru_scan_fwd_plain(*_t(gx, sW), reverse=reverse,
                                    residuals=True)
    h_prev = tlstm.prev_state(h, reverse)
    iw = iW if with_iw else None
    want = pallas_rnn.gru_bwd(
        *_j(dh, gx, gh.numpy(), h_prev.numpy(), sW), block_t=BT,
        interpret=True, reverse=reverse,
        iW=None if iw is None else jnp.asarray(iw))
    got = tgru.gru_scan_bwd(*_t(dh, gx), gh, h_prev, *_t(sW),
                            reverse=reverse,
                            iW=None if iw is None else _t(iw)[0])
    assert len(got) == len(want) == (3 if with_iw else 2)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4, 1e-5)


SCANS = {"lstm": (4, trnn.lstm_scan, jrnn.lstm_scan),
         "gru": (3, trnn.gru_scan, jrnn.gru_scan)}


def _port_vjp(scan, gx, sW, dh, reverse):
    """h and (d gates_x, d_sW) of the port's scan, through autograd."""
    tgx, tsw = (a.requires_grad_() for a in _t(gx, sW))
    h = scan(tgx, tsw, reverse=reverse)
    grads = torch.autograd.grad(h, (tgx, tsw), _t(dh)[0])
    return h.detach(), grads


def _jax_vjp(scan, gx, sW, dh, reverse):
    h, vjp = jax.vjp(lambda g, w: scan(g, w, reverse=reverse), *_j(gx, sW))
    return h, vjp(jnp.asarray(dh))


@pytest.mark.parametrize("cell", sorted(SCANS))
@pytest.mark.parametrize("reverse", DIRS)
def test_scan_matches_jax_vjp(cell, reverse):
    """h, d gates_x and d_sW against jax.vjp on the JAX package's CPU
    scan path, at odd T and B; gates_x is left as it was."""
    G, tscan, jscan = SCANS[cell]
    gx, sW, dh, _ = _inputs(G, 37, 5, seed=5)
    keep = gx.copy()
    h, (dgx, dsw) = _port_vjp(tscan, gx, sW, dh, reverse)
    jh, (jdgx, jdsw) = _jax_vjp(jscan, gx, sW, dh, reverse)
    _close(h.numpy(), jh, 1e-5, 1e-6)
    _close(dgx.numpy(), jdgx, 1e-4, 1e-5)
    _close(dsw.numpy(), jdsw, 1e-4, 1e-4)
    np.testing.assert_array_equal(gx, keep)
    with torch.no_grad():
        assert torch.equal(tscan(*_t(gx, sW), reverse=reverse), h)


@pytest.mark.parametrize("cell", sorted(SCANS))
@pytest.mark.parametrize("reverse", DIRS)
def test_scan_matches_jax_pallas_interpret(cell, reverse, monkeypatch):
    """The same against the JAX package's Pallas route
    (TAIYAKI_TPU_PALLAS_INTERPRET=1, B=8, gate and gradient streams in
    f32), which keeps its residuals in bf16: h as above, the gradients
    within 5e-3 of each one's largest value."""
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TAIYAKI_TPU_F32_GATES", "1")
    monkeypatch.setenv("TAIYAKI_TPU_F32_GRADS", "1")
    G, tscan, jscan = SCANS[cell]
    gx, sW, dh, _ = _inputs(G, 19, 8, seed=6)
    assert jrnn._use_pallas(8)
    h, grads = _port_vjp(tscan, gx, sW, dh, reverse)
    jh, jgrads = _jax_vjp(jscan, gx, sW, dh, reverse)
    _close(h.numpy(), jh, 1e-5, 1e-6)
    for g, w in zip(grads, jgrads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 5e-3 * np.abs(w).max()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", DIRS)
def test_scan_of_input_gates_matches_layer(cell, reverse):
    """scan(x . iW^T + b, sW) equals the whole layer on x in the port: h,
    and through autograd d_x, d_iW, d_b and d_sW (kernels 14-17 tied to
    the layer kernels 1, 4, 7 and 8 through their twins)."""
    G, tscan, _ = SCANS[cell]
    layer = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    rng = np.random.default_rng(7)
    x = rng.normal(size=(21, 6, D)).astype(np.float32)
    iW = (0.3 * rng.normal(size=(G * H, D))).astype(np.float32)
    b = (0.3 * rng.normal(size=G * H)).astype(np.float32)
    sW = (0.3 * rng.normal(size=(G * H, H))).astype(np.float32)
    dh = torch.from_numpy(rng.normal(size=(21, 6, H)).astype(np.float32))
    out = {}
    for how in ("scan", "layer"):
        leaves = [a.requires_grad_() for a in _t(x, iW, b, sW)]
        xt, iwt, bt, swt = leaves
        if how == "scan":
            h = tscan(torch.matmul(xt, iwt.t()) + bt, swt, reverse=reverse)
        else:
            h = layer(xt, iwt, bt, swt, reverse=reverse)
        out[how] = [h.detach()] + list(torch.autograd.grad(h, leaves, dh))
    for g, w in zip(out["scan"], out["layer"]):
        _close(g.numpy(), w.numpy(), 1e-4, 1e-4)
