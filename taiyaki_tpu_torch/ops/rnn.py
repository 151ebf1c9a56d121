"""Recurrent layers (port of taiyaki_tpu/ops/rnn.py, LSTM).

`lstm_layer` is the whole layer, input product included, as a
`torch.autograd.Function` for both directions.  Under grad its forward
runs the forward kernel of `ops.lstm` with emit="acts", keeping c, the
activated gates and tanh(c) for the backward, which is `lstm_bwd_acts`;
with no grad it runs the forward kernel alone (emit=None).  On a CPU
tensor the plain PyTorch twins run.  `reverse=True` runs the recurrence
backwards in time with inputs and outputs in natural time order.
"""

import torch

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


def lstm_layer(x, iW, b, sW, reverse=False):
    """Whole LSTM layer: h = lstm(x @ iW.T + b; sW), direction `reverse`.

    Args:
        x: [T, B, D] f32; iW: [4H, D]; b: [4H]; sW: [4H, H] (gate order
            i, f, g, o).

    Returns:
        h: [T, B, H] hidden states.
    """
    args = [t.contiguous() for t in (x, iW, b, sW)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LstmLayer.apply(*args, bool(reverse))
    return lstm_fwd(*args, reverse=reverse)
