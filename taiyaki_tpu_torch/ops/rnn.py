"""Recurrent layers (port of taiyaki_tpu/ops/rnn.py, LSTM and GRU).

`lstm_layer` and `gru_layer` are whole layers, input product included, as
`torch.autograd.Function`s for both directions.  With no grad each runs
its forward kernel alone.  Under grad the LSTM's forward runs the forward
kernel of `ops.lstm` with emit="acts", keeping c, the activated gates and
tanh(c) for the backward, which is `lstm_bwd_acts`; the GRU's forward
keeps only x and h, and its backward `gru_bwd_recompute` rebuilds the gate
streams (the JAX package's GRU default, ops/rnn.py:634-643; its
stored-stream variant, TAIYAKI_TPU_NO_RECOMPUTE=1, is not ported yet and
raises).  On a CPU tensor the plain PyTorch twins run.  `reverse=True`
runs the recurrence backwards in time with inputs and outputs in natural
time order.
"""

import os

import torch

from taiyaki_tpu_torch.ops.gru import gru_bwd_recompute, gru_fwd
from taiyaki_tpu_torch.ops.lstm import lstm_bwd_acts, lstm_fwd, prev_state


class _LstmLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, iW, b, sW, reverse):
        h, c, acts, tc = lstm_fwd(x, iW, b, sW, reverse=reverse,
                                  emit="acts")
        ctx.reverse = reverse
        ctx.save_for_backward(x, h, c, acts, tc, iW, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, c, acts, tc, iW, sW = ctx.saved_tensors
        d_x, d_sW, d_iW, d_b = lstm_bwd_acts(
            dh.contiguous(), acts, tc, prev_state(c, ctx.reverse), h, x, sW,
            iW, reverse=ctx.reverse)
        # the weight gradients come back as partial sums
        return d_x, d_iW.sum(0), d_b.sum(0), d_sW.sum(0), None


class _GruLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, iW, b, sW, reverse):
        if os.environ.get("TAIYAKI_TPU_NO_RECOMPUTE") == "1":
            raise NotImplementedError(
                "the GRU backward from stored gate streams "
                "(TAIYAKI_TPU_NO_RECOMPUTE=1, pallas_rnn.gru_bwd_fusedw) is "
                "not ported yet")
        h = gru_fwd(x, iW, b, sW, reverse=reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(x, h, iW, b, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, iW, b, sW = ctx.saved_tensors
        d_x, d_sW, d_iW, d_b = gru_bwd_recompute(
            dh.contiguous(), h, x, sW, iW, b, reverse=ctx.reverse)
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
