"""Recurrent layers (port of taiyaki_tpu/ops/rnn.py, LSTM and GRU).

`lstm_layer` and `gru_layer` are whole layers, input product included, as
`torch.autograd.Function`s for both directions.  With no grad each runs
its forward kernel alone.  Under grad the forward keeps the residuals of
the backward that the JAX package's switches choose (its ops/rnn.py:87-121,
read once per forward call and kept for the backward):

- LSTM, by default: c, the activated gates and tanh(c) (forward emit
  "acts"; backward `lstm_bwd_acts`); TAIYAKI_TPU_ACTS_BWD=0: c and the
  pre-activations (emit "pre"; `lstm_bwd_fusedw`); TAIYAKI_TPU_RECOMPUTE=1:
  c alone (emit "c"; `lstm_bwd_recompute`, which rebuilds pre from x and h).
- GRU, by default: x and h alone (`gru_bwd_recompute` rebuilds the gate
  streams); TAIYAKI_TPU_NO_RECOMPUTE=1: the gate streams gx and gh too
  (`gru_fwd` with emit_residuals; `gru_bwd_fusedw`).

TAIYAKI_TPU_NO_RECOMPUTE=1 wins over TAIYAKI_TPU_RECOMPUTE=1 for both
cells, and TAIYAKI_TPU_ACTS_BWD is read only when the LSTM stores its
residuals.  On a CPU tensor the plain PyTorch twins run.  `reverse=True`
runs the recurrence backwards in time with inputs and outputs in natural
time order.
"""

import os

import torch

from taiyaki_tpu_torch.ops.gru import gru_bwd_fusedw, gru_bwd_recompute, \
    gru_fwd
from taiyaki_tpu_torch.ops.lstm import lstm_bwd_acts, lstm_bwd_fusedw, \
    lstm_bwd_recompute, lstm_fwd, prev_state


def _recompute_pre(cell):
    """Whether `cell`'s ("lstm" or "gru") layer backward rebuilds its gate
    streams instead of reading stored residuals (taiyaki_tpu/ops/rnn.py:87-
    109): TAIYAKI_TPU_NO_RECOMPUTE=1 stores for both cells,
    TAIYAKI_TPU_RECOMPUTE=1 rebuilds for both, and by default the GRU
    rebuilds and the LSTM stores."""
    if os.environ.get("TAIYAKI_TPU_NO_RECOMPUTE") == "1":
        return False
    if os.environ.get("TAIYAKI_TPU_RECOMPUTE") == "1":
        return True
    return cell == "gru"


def _acts_bwd():
    """Whether the LSTM's stored residuals are the activated gates and
    tanh(c) (default) or the pre-activations (TAIYAKI_TPU_ACTS_BWD=0)
    (taiyaki_tpu/ops/rnn.py:112-121)."""
    return os.environ.get("TAIYAKI_TPU_ACTS_BWD", "1") == "1"


def lstm_policy():
    """The LSTM layer's residual policy: "recompute", "acts" or "pre" (the
    forward's emit mode for the first, "c", aside)."""
    if _recompute_pre("lstm"):
        return "recompute"
    return "acts" if _acts_bwd() else "pre"


def gru_policy():
    """The GRU layer's residual policy: "recompute" or "stored"."""
    return "recompute" if _recompute_pre("gru") else "stored"


class _LstmLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, iW, b, sW, reverse):
        ctx.policy = lstm_policy()
        ctx.reverse = reverse
        emit = "c" if ctx.policy == "recompute" else ctx.policy
        h, c, *res = lstm_fwd(x, iW, b, sW, reverse=reverse, emit=emit)
        ctx.save_for_backward(x, h, c, iW, b, sW, *res)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, c, iW, b, sW, *res = ctx.saved_tensors
        dh = dh.contiguous()
        rev = ctx.reverse
        if ctx.policy == "recompute":
            d_x, d_sW, d_iW, d_b = lstm_bwd_recompute(dh, c, h, x, sW, iW, b,
                                                      reverse=rev)
        else:
            # (acts, tanh c) or (pre, c), then c_prev
            if ctx.policy == "acts":
                bwd, (gates, cs) = lstm_bwd_acts, res
            else:
                bwd, gates, cs = lstm_bwd_fusedw, res[0], c
            d_x, d_sW, d_iW, d_b = bwd(dh, gates, cs, prev_state(c, rev), h,
                                       x, sW, iW, reverse=rev)
        # the weight gradients come back as partial sums
        return d_x, d_iW.sum(0), d_b.sum(0), d_sW.sum(0), None


class _GruLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, iW, b, sW, reverse):
        ctx.policy = gru_policy()
        ctx.reverse = reverse
        if ctx.policy == "stored":
            h, gh, gx = gru_fwd(x, iW, b, sW, reverse=reverse,
                                emit_residuals=True)
            ctx.save_for_backward(x, h, iW, b, sW, gx, gh)
        else:
            h = gru_fwd(x, iW, b, sW, reverse=reverse)
            ctx.save_for_backward(x, h, iW, b, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, iW, b, sW, *res = ctx.saved_tensors
        dh = dh.contiguous()
        rev = ctx.reverse
        if ctx.policy == "stored":
            d_x, d_sW, d_iW, d_b = gru_bwd_fusedw(
                dh, *res, prev_state(h, rev), x, sW, iW, reverse=rev)
        else:
            d_x, d_sW, d_iW, d_b = gru_bwd_recompute(dh, h, x, sW, iW, b,
                                                     reverse=rev)
        return d_x, d_iW.sum(0), d_b.sum(0), d_sW.sum(0), None


def _layer(fn, forward, x, iW, b, sW, reverse):
    args = [t.contiguous() for t in (x, iW, b, sW)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return fn.apply(*args, bool(reverse))
    return forward(*args, reverse=reverse)


def lstm_layer(x, iW, b, sW, reverse=False):
    """Whole LSTM layer: h = lstm(x @ iW.T + b; sW), direction `reverse`.

    Args:
        x: [T, B, D] f32; iW: [4H, D]; b: [4H]; sW: [4H, H] (gate order
            i, f, g, o).

    Returns:
        h: [T, B, H] hidden states.
    """
    return _layer(_LstmLayer, lstm_fwd, x, iW, b, sW, reverse)


def gru_layer(x, iW, b, sW, reverse=False):
    """Whole GRU layer: h = gru(x @ iW.T + b; sW), direction `reverse`.

    Args:
        x: [T, B, D] f32; iW: [3H, D]; b: [3H]; sW: [3H, H] (gate order
            r, z, n).

    Returns:
        h: [T, B, H] hidden states.
    """
    return _layer(_GruLayer, gru_fwd, x, iW, b, sW, reverse)
