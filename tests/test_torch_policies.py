"""The residual policies of the port's recurrent layers on the CPU: the
switches TAIYAKI_TPU_ACTS_BWD, TAIYAKI_TPU_RECOMPUTE and
TAIYAKI_TPU_NO_RECOMPUTE choose the forward's residuals and the backward
as the JAX package's ops/rnn.py decides them (its _recompute_pre and
_acts_bwd), the choice is made once per forward call, and a retained
graph gives the same gradients twice.

Routing is observed by wrapping the backward functions the layers call.
A retained graph's two passes must agree exactly (the same twins on the
same inputs); a policy's gradients the default's within 1e-5 of each
gradient's largest value (the same math, sums in another order)."""

import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch.ops import rnn as trnn

NAMES = ("TAIYAKI_TPU_ACTS_BWD", "TAIYAKI_TPU_RECOMPUTE",
         "TAIYAKI_TPU_NO_RECOMPUTE")

# (environment, LSTM policy, GRU policy)
CASES = [
    ({}, "acts", "recompute"),
    ({"TAIYAKI_TPU_ACTS_BWD": "0"}, "pre", "recompute"),
    ({"TAIYAKI_TPU_ACTS_BWD": "1"}, "acts", "recompute"),
    ({"TAIYAKI_TPU_RECOMPUTE": "1"}, "recompute", "recompute"),
    ({"TAIYAKI_TPU_RECOMPUTE": "1", "TAIYAKI_TPU_ACTS_BWD": "0"},
     "recompute", "recompute"),
    ({"TAIYAKI_TPU_NO_RECOMPUTE": "1"}, "acts", "stored"),
    ({"TAIYAKI_TPU_NO_RECOMPUTE": "1", "TAIYAKI_TPU_RECOMPUTE": "1"},
     "acts", "stored"),
    ({"TAIYAKI_TPU_NO_RECOMPUTE": "1", "TAIYAKI_TPU_ACTS_BWD": "0"},
     "pre", "stored"),
    ({"TAIYAKI_TPU_NO_RECOMPUTE": "1", "TAIYAKI_TPU_RECOMPUTE": "1",
      "TAIYAKI_TPU_ACTS_BWD": "0"}, "pre", "stored"),
    ({"TAIYAKI_TPU_NO_RECOMPUTE": "0", "TAIYAKI_TPU_RECOMPUTE": "0"},
     "acts", "recompute"),
]
BWD = {"lstm": {"acts": "lstm_bwd_acts", "pre": "lstm_bwd_fusedw",
                "recompute": "lstm_bwd_recompute"},
       "gru": {"recompute": "gru_bwd_recompute", "stored": "gru_bwd_fusedw"}}


def _set_env(monkeypatch, env):
    for name in NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


def _jax_lstm_policy():
    """The branch taiyaki_tpu/ops/rnn.py's LSTM layer takes (its fwd)."""
    if jrnn._recompute_pre("lstm"):
        return "recompute"
    return "acts" if jrnn._acts_bwd() else "pre"


@pytest.mark.parametrize("env,lstm,gru", CASES)
def test_policy_precedence_matches_jax(env, lstm, gru, monkeypatch):
    """NO_RECOMPUTE wins over RECOMPUTE for both cells; ACTS_BWD counts
    only where the LSTM stores its residuals, and never for the GRU."""
    _set_env(monkeypatch, env)
    assert trnn.lstm_policy() == _jax_lstm_policy() == lstm
    assert trnn.gru_policy() == gru
    assert (gru == "recompute") == jrnn._recompute_pre("gru")


def _inputs(cell, seed, T=13, B=3, D=5, H=8):
    rng = np.random.default_rng(seed)
    G = {"lstm": 4, "gru": 3}[cell] * H
    arrays = (rng.normal(size=(T, B, D)), 0.4 * rng.normal(size=(G, D)),
              rng.normal(size=(G,)), 0.4 * rng.normal(size=(G, H)),
              rng.normal(size=(T, B, H)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _spy(monkeypatch):
    """Wrap every backward the layers call; returns the list of the names
    called, in order."""
    calls = []
    for names in BWD.values():
        for name in names.values():
            fn = getattr(trnn, name)

            def spy(*args, _fn=fn, _name=name, **kw):
                calls.append(_name)
                return _fn(*args, **kw)
            monkeypatch.setattr(trnn, name, spy)
    return calls


def _run(cell, seed, reverse):
    """Forward and backward of one layer; (h, [d_x, d_iW, d_b, d_sW])."""
    x, iW, b, sW, dh = _inputs(cell, seed)
    leaves = [a.requires_grad_() for a in (x, iW, b, sW)]
    layer = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    h = layer(*leaves, reverse=reverse)
    h.backward(dh)
    return h, [a.grad for a in leaves]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("env,lstm,gru", CASES)
def test_switch_routes_the_backward(env, lstm, gru, reverse, monkeypatch):
    """Each layer's backward is the one its policy names, and no other."""
    _set_env(monkeypatch, env)
    calls = _spy(monkeypatch)
    for cell, policy in (("lstm", lstm), ("gru", gru)):
        del calls[:]
        _run(cell, 1, reverse)
        assert calls == [BWD[cell][policy]]


@pytest.mark.parametrize("cell,env,policy", [
    ("lstm", {"TAIYAKI_TPU_RECOMPUTE": "1"}, "recompute"),
    ("lstm", {"TAIYAKI_TPU_ACTS_BWD": "0"}, "pre"),
    ("gru", {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}, "stored")])
def test_backward_keeps_the_forwards_policy(cell, env, policy, monkeypatch):
    """The policy is read at the forward call: a switch changed between
    forward and backward changes nothing."""
    _set_env(monkeypatch, env)
    calls = _spy(monkeypatch)
    x, iW, b, sW, dh = _inputs(cell, 2)
    layer = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    h = layer(*[a.requires_grad_() for a in (x, iW, b, sW)])
    _set_env(monkeypatch, {"TAIYAKI_TPU_RECOMPUTE": "0",
                           "TAIYAKI_TPU_NO_RECOMPUTE": "0",
                           "TAIYAKI_TPU_ACTS_BWD": "1"})
    h.backward(dh)
    assert calls == [BWD[cell][policy]]


POLICY_ENVS = [("lstm", {}), ("lstm", {"TAIYAKI_TPU_ACTS_BWD": "0"}),
               ("lstm", {"TAIYAKI_TPU_RECOMPUTE": "1"}), ("gru", {}),
               ("gru", {"TAIYAKI_TPU_NO_RECOMPUTE": "1"})]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,env", POLICY_ENVS)
def test_retained_graph_gives_the_same_gradients_twice(cell, env, reverse,
                                                       monkeypatch):
    """backward(retain_graph=True) twice: the second pass reads the saved
    residuals unchanged and adds the same gradients again."""
    _set_env(monkeypatch, env)
    x, iW, b, sW, dh = _inputs(cell, 3)
    leaves = [a.requires_grad_() for a in (x, iW, b, sW)]
    layer = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    h = layer(*leaves, reverse=reverse)
    first = torch.autograd.grad(h, leaves, dh, retain_graph=True)
    second = torch.autograd.grad(h, leaves, dh)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("cell,env", POLICY_ENVS[1:3] + POLICY_ENVS[4:])
def test_policy_gradients_equal_the_defaults(cell, env, monkeypatch):
    """Each stored or rebuilt policy gives the default policy's h exactly
    and its gradients within 1e-5 of each gradient's largest value (the
    same math, sums in another order)."""
    _set_env(monkeypatch, {})
    h0, g0 = _run(cell, 4, False)
    _set_env(monkeypatch, env)
    h1, g1 = _run(cell, 4, False)
    assert torch.equal(h0, h1)
    for a, b_ in zip(g0, g1):
        assert (a - b_).abs().max().item() <= 1e-5 * max(
            1.0, a.abs().max().item())
