"""The port's squiggle match (ops/squiggle.py) against the JAX package's:
the embedding, the cost and its gradient (jax.grad of the JAX scan)
through padded batches, and the glocal Viterbi path (the port's C++
against the JAX package's native kernel and its numpy loop).

Tolerances: costs 1e-5 relative (f32 over the same recursion, the
emissions formed in one batch of ops); gradients 1e-4 of each case's
largest (f32 autodiff of the recursion in another order); Viterbi paths
equal, scores within 1e-5 (the same C++)."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import squiggle as jsq
from taiyaki_tpu_torch.ops import squiggle as tsq
# one_torch_thread is an autouse fixture
from test_torch_cli import one_torch_thread  # noqa: F401


def _case(npos, back_prob, seed=0, nbatch=3, rate_scale=1.0):
    """Seeded params [npos, B, 3], signals [T, B] and padded siglens."""
    rng = np.random.default_rng(seed + 17 * npos)
    params = rng.normal(size=(npos, nbatch, 3)).astype(np.float32)
    params[:, :, 1] = -np.abs(params[:, :, 1]) * 0.5
    params[:, :, 2] *= rate_scale
    nsample = 3 * npos + 5
    signals = rng.normal(size=(nsample, nbatch)).astype(np.float32)
    siglens = np.array([nsample, nsample - 4, max(1, nsample // 2)],
                       dtype=np.int32)[:nbatch]
    return params, signals, siglens, back_prob


def _port_cost_grad(params, signals, siglens, back_prob):
    p = torch.tensor(params, requires_grad=True)
    cost = tsq.squiggle_match_cost(p, torch.from_numpy(signals),
                                   torch.from_numpy(siglens), back_prob)
    (grad,) = torch.autograd.grad(cost.sum(), p)
    return cost.detach().numpy(), grad.numpy()


def _jax_cost_grad(params, signals, siglens, back_prob):
    def total(p):
        return jnp.sum(jsq.squiggle_match_cost(p, signals, siglens,
                                               back_prob))
    cost = jsq.squiggle_match_cost(params, signals, siglens, back_prob)
    return np.asarray(cost), np.asarray(jax.grad(total)(
        jnp.asarray(params)))


def test_embed_sequence_matches_jax():
    np.testing.assert_array_equal(tsq.CARTESIAN_TETRAHEDRON,
                                  jsq.CARTESIAN_TETRAHEDRON)
    np.testing.assert_array_equal(tsq.embed_sequence("ACGTTGCA"),
                                  jsq.embed_sequence("ACGTTGCA"))
    labels = np.array([3, 0, 2, 1, 1])
    np.testing.assert_array_equal(tsq.embed_sequence(labels, alphabet=None),
                                  jsq.embed_sequence(labels, alphabet=None))


@pytest.mark.parametrize("back_prob", [1e-15, 0.05])
@pytest.mark.parametrize("npos", [1, 2, 7, 33])
def test_cost_and_gradient_match_jax(npos, back_prob):
    case = _case(npos, back_prob)
    cost, grad = _port_cost_grad(*case)
    jcost, jgrad = _jax_cost_grad(*case)
    assert np.isfinite(cost).all()
    np.testing.assert_allclose(cost, jcost, rtol=1e-5)
    assert np.abs(grad - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


@pytest.mark.parametrize("rate", [30.0, -30.0])
def test_extreme_rates_give_finite_gradients(rate):
    params, signals, siglens, _ = _case(7, 1e-15, seed=3)
    params[:, :, 2] = rate
    cost, grad = _port_cost_grad(params, signals, siglens, 1e-15)
    assert np.isfinite(cost).all() and np.isfinite(grad).all()
    jcost, jgrad = _jax_cost_grad(params, signals, siglens, 1e-15)
    np.testing.assert_allclose(cost, jcost, rtol=1e-5)
    assert np.abs(grad - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


def test_padding_columns_change_no_cost():
    """Samples past a signal's length, and extra padded samples at the end
    of the batch, leave every cost as it was."""
    params, signals, siglens, back_prob = _case(7, 0.05, seed=5)
    cost, _ = _port_cost_grad(params, signals, siglens, back_prob)
    padded = np.concatenate([signals, np.full((9, 3), 99.0, np.float32)])
    for j in range(3):
        padded[siglens[j]:, j] = 99.0
    cost2, _ = _port_cost_grad(params, padded, siglens, back_prob)
    np.testing.assert_array_equal(cost, cost2)


@pytest.mark.parametrize("native", [True, False],
                         ids=["jax_native", "jax_numpy"])
def test_viterbi_path_matches_jax(native):
    """Six random cases with and without localpen and minscore (as the
    JAX package's own native-against-numpy test runs them): the port's C++
    against the JAX package's C++, and against its numpy loop
    (TAIYAKI_TPU_NO_NATIVE=1 on the JAX side only)."""
    rng = np.random.default_rng(123)
    env = {} if native else {"TAIYAKI_TPU_NO_NATIVE": "1"}
    for trial in range(6):
        npos = int(rng.integers(3, 40))
        nsample = int(rng.integers(10, 200))
        params = rng.normal(size=(npos, 3)).astype(np.float32)
        params[:, 1] = -np.abs(params[:, 1])
        signal = rng.normal(size=nsample).astype(np.float32)
        kw = dict(localpen=[None, 0.5, 2.0][trial % 3],
                  minscore=[None, 4.0][trial % 2])
        back_prob = [1e-6, 0.05][trial % 2]
        score, path = tsq.squiggle_match_viterbi_path(params, signal,
                                                      back_prob, **kw)
        with mock.patch.dict(os.environ, env):
            jscore, jpath = jsq.squiggle_match_viterbi_path(
                params, signal, back_prob, **kw)
        np.testing.assert_array_equal(path, jpath)
        np.testing.assert_allclose(score, jscore, rtol=1e-5, atol=1e-5)


def test_viterbi_rejects_empty_inputs():
    with pytest.raises(ValueError, match="signal"):
        tsq.squiggle_match_viterbi_path(np.zeros((3, 3), np.float32),
                                        np.zeros(0, np.float32), 0.1)
    with pytest.raises(ValueError, match="params"):
        tsq.squiggle_match_viterbi_path(np.zeros((0, 3), np.float32),
                                        np.zeros(5, np.float32), 0.1)


def _cost_f64(params, signals, siglens, back_prob):
    """The squiggle match recursion in f64, written out here: the same
    states and transitions as ops/squiggle.py."""
    npos, nbatch, _ = params.shape
    sig = torch.as_tensor(signals, dtype=torch.float64)
    loc, logscale, rate = (params[:, :, i].t() for i in range(3))
    log_no_back = np.log1p(-back_prob)
    move = log_no_back + torch.nn.functional.logsigmoid(rate)[:, 1:]
    stay = torch.cat([log_no_back + torch.nn.functional.logsigmoid(-rate),
                      torch.full_like(rate, np.log(0.5))], dim=1)
    emit = (-torch.abs(sig[:, :, None] - loc) / torch.exp(logscale)
            - logscale - np.log(2.0))
    emit = torch.cat([emit, emit], dim=2)
    fwd = torch.full((nbatch, 2 * npos), -1e300, dtype=torch.float64)
    fwd[:, 0] = 0.0
    for t in range(sig.shape[0]):
        s = fwd + stay
        pos = torch.logaddexp(torch.logaddexp(s[:, 1:npos],
                                              fwd[:, :npos - 1] + move),
                              s[:, npos:-1])
        back = torch.logaddexp(s[:, npos:-1],
                               fwd[:, 1:npos] + np.log(back_prob))
        new = torch.cat([s[:, :1], pos, back, s[:, -1:]], dim=1) + emit[t]
        fwd = torch.where(torch.as_tensor(t < siglens)[:, None], new, fwd)
    return -fwd[:, npos - 1]


def test_long_signal_gradient_against_f64():
    """2000 samples, where the forward reaches -3000 in log space: the
    port's f32 cost and gradient against the recursion in f64.  With the
    recursion in f32 the gradient was 1.2e-4 of its largest away (and the
    cost 6e-6)."""
    rng = np.random.default_rng(0)
    npos, nsample = 300, 2000
    params = rng.normal(size=(npos, 2, 3)).astype(np.float32)
    params[:, :, 1] = -np.abs(params[:, :, 1]) * 0.5
    signals = rng.normal(size=(nsample, 2)).astype(np.float32)
    siglens = np.array([nsample, nsample - 7], dtype=np.int32)
    cost, grad = _port_cost_grad(params, signals, siglens, 0.05)
    p64 = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    cost64 = _cost_f64(p64, signals, siglens, 0.05)
    (grad64,) = torch.autograd.grad(cost64.sum(), p64)
    cost64, grad64 = cost64.detach().numpy(), grad64.numpy()
    np.testing.assert_allclose(cost, cost64, rtol=5e-6)
    assert np.abs(grad - grad64).max() <= 1e-5 * np.abs(grad64).max()
