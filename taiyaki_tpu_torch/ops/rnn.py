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

`lstm_scan` and `gru_scan` are the recurrences over given input gates
(the JAX package's ops/rnn.py:330 and :597, each with its own VJP): the
forward keeps h, c and pre (LSTM, kernel 14) or h, gates_x and gh (GRU,
kernel 16); the backward gives d gates_x from kernel 15 or 17 and d_sW =
sum_t dgates_t^T h_prev_t as one product over all steps (the JAX
package's einsum outside Pallas): torch.matmul of f32 gradients, the tc
atb GEMM (ops/gemm.py) of bf16 ones.  With no grad, the forward kernel
emits h alone.

Streams.  By default every stream is f32: the JAX package's precision on
the CPU and in its inference CLIs.  TAIYAKI_TPU_BF16_STREAMS=1 (read once
per forward call, kept for the backward) makes the LSTM and GRU layers
store what the JAX package's TPU kernels store under its mixed precision
(taiyaki_tpu/ops/rnn.py:29-42, :345-470 and :612-712): the residuals
(LSTM c, pre, acts, tc; GRU gh and gx, stored policy) in bf16, the
activation stream h in bf16 unless TAIYAKI_TPU_F32_GATES=1 or
TAIYAKI_TPU_BF16_ACTS=0, the gradient stream dh in bf16 unless
TAIYAKI_TPU_F32_GRADS=1 (then dh keeps the dtype autograd gives it, h's),
and d_x in x's dtype; the carries, every product's sums, the weight
gradients, the optimizer state and the checkpoints stay f32.  Under the
switch the scans store what the JAX scans store (its ops/rnn.py:222-228,
:248, :548-575, `scan_streams`): the gate stream gx in bf16 unless
TAIYAKI_TPU_F32_GATES=1, the residuals (LSTM c and pre, GRU gh) in bf16,
h in f32 whatever TAIYAKI_TPU_BF16_ACTS says, dh and the gradient streams
(dpre, or dgx and dgh) in bf16 unless TAIYAKI_TPU_F32_GRADS=1, and d
gates_x comes back in dh's dtype.  The JAX package keeps f32 streams
wherever Mosaic's B % 8 rule sends it to its scan path; the port applies
the switch at any B.
"""

import collections
import contextlib
import os

import torch

from taiyaki_tpu_torch.ops.gemm import atb_gemm
from taiyaki_tpu_torch.ops.gru import gru_bwd_fusedw, gru_bwd_recompute, \
    gru_fwd, gru_scan_bwd, gru_scan_fwd
from taiyaki_tpu_torch.ops.lstm import lstm_bwd_acts, lstm_bwd_fusedw, \
    lstm_bwd_recompute, lstm_fwd, lstm_scan_bwd, lstm_scan_fwd, prev_state


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


BF16_SWITCH = "TAIYAKI_TPU_BF16_STREAMS"
# the dtypes of the recurrent layers' streams under the switch: h (the act
# stream) and dh (the gradient stream; None keeps dh's own dtype)
Streams = collections.namedtuple("Streams", "h dh")
# the dtypes of the scans' streams under the switch: gx (the gate stream;
# None keeps gates_x's own dtype), the residuals, and dh with the gradient
# streams (None keeps dh's own dtype); h stays f32
ScanStreams = collections.namedtuple("ScanStreams", "gx res dh")


def bf16_streams():
    """The recurrent layers' Streams under TAIYAKI_TPU_BF16_STREAMS=1,
    read as taiyaki_tpu/ops/rnn.py:136-174 reads its switches; None when
    unset (every stream f32)."""
    if os.environ.get(BF16_SWITCH) != "1":
        return None
    f32_h = (os.environ.get("TAIYAKI_TPU_F32_GATES") == "1"
             or os.environ.get("TAIYAKI_TPU_BF16_ACTS") == "0")
    return Streams(torch.float32 if f32_h else torch.bfloat16,
                   None if os.environ.get("TAIYAKI_TPU_F32_GRADS") == "1"
                   else torch.bfloat16)


def scan_streams():
    """The scans' ScanStreams under TAIYAKI_TPU_BF16_STREAMS=1, the JAX
    scans' (taiyaki_tpu/ops/rnn.py:124-134 `_gate_stream_dtype`, :166-174
    `_grad_stream_dtype`; residuals bf16 and h f32 whatever
    TAIYAKI_TPU_BF16_ACTS says); None when unset (every stream f32)."""
    if os.environ.get(BF16_SWITCH) != "1":
        return None
    return ScanStreams(
        None if os.environ.get("TAIYAKI_TPU_F32_GATES") == "1"
        else torch.bfloat16, torch.bfloat16,
        None if os.environ.get("TAIYAKI_TPU_F32_GRADS") == "1"
        else torch.bfloat16)


# the inference CLIs' opt-out of the bf16 streams (the JAX package's
# bin/basecall.py:380-381, bin/prepare_mapped_reads.py:57-58)
INFERENCE_F32 = ("TAIYAKI_TPU_F32_GATES", "TAIYAKI_TPU_F32_SCORES")


@contextlib.contextmanager
def f32_inference():
    """Within: each of INFERENCE_F32 set to "1" unless exported, as the
    JAX inference CLIs `setdefault` them, so that their calls stay f32
    whatever TAIYAKI_TPU_BF16_STREAMS says; those set here are unset
    again on leaving, since the port's CLIs also run inside other
    processes (its tests, chip_smoke.py)."""
    unset = [k for k in INFERENCE_F32 if k not in os.environ]
    for k in unset:
        os.environ[k] = "1"
    try:
        yield
    finally:
        for k in unset:
            os.environ.pop(k, None)


def _stream_dtypes(streams):
    """The forward's dtype arguments under the switch's Streams (none when
    unset): h in the act stream's dtype, the bf16 instance."""
    return ({} if streams is None else
            {"h_dtype": streams.h, "res_dtype": torch.bfloat16})


class _LstmLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, iW, b, sW, reverse):
        ctx.policy = lstm_policy()
        ctx.streams = bf16_streams()
        ctx.reverse = reverse
        emit = "c" if ctx.policy == "recompute" else ctx.policy
        h, c, *res = lstm_fwd(x, iW, b, sW, reverse=reverse, emit=emit,
                              **_stream_dtypes(ctx.streams))
        ctx.save_for_backward(x, h, c, iW, b, sW, *res)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, c, iW, b, sW, *res = ctx.saved_tensors
        dh = dh.contiguous()
        if ctx.streams is not None and ctx.streams.dh is not None:
            dh = dh.to(ctx.streams.dh)
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
        ctx.streams = bf16_streams()
        ctx.reverse = reverse
        dtypes = _stream_dtypes(ctx.streams)
        if ctx.policy == "stored":
            h, gh, gx = gru_fwd(x, iW, b, sW, reverse=reverse,
                                emit_residuals=True, **dtypes)
            ctx.save_for_backward(x, h, iW, b, sW, gx, gh)
        else:
            h = gru_fwd(x, iW, b, sW, reverse=reverse, **dtypes)
            ctx.save_for_backward(x, h, iW, b, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, h, iW, b, sW, *res = ctx.saved_tensors
        dh = dh.contiguous()
        if ctx.streams is not None and ctx.streams.dh is not None:
            dh = dh.to(ctx.streams.dh)
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


def _infer(fwd, x, iW, b, sW, reverse):
    """A layer's forward `fwd` with no grad: h alone, in the act stream's
    dtype under the switch (the bf16 instance wherever x or h is bf16)."""
    streams = bf16_streams()
    if streams is None or torch.bfloat16 not in (x.dtype, streams.h):
        return fwd(x, iW, b, sW, reverse=reverse)
    return fwd(x, iW, b, sW, reverse=reverse, **_stream_dtypes(streams))


def _lstm_infer(x, iW, b, sW, reverse=False):
    """The LSTM layer's forward with no grad (`_infer`)."""
    return _infer(lstm_fwd, x, iW, b, sW, reverse)


def _gru_infer(x, iW, b, sW, reverse=False):
    """The GRU layer's forward with no grad (`_infer`)."""
    return _infer(gru_fwd, x, iW, b, sW, reverse)


def lstm_layer(x, iW, b, sW, reverse=False):
    """Whole LSTM layer: h = lstm(x @ iW.T + b; sW), direction `reverse`.

    Args:
        x: [T, B, D] f32 (or bf16 under TAIYAKI_TPU_BF16_STREAMS=1); iW:
            [4H, D]; b: [4H]; sW: [4H, H] (gate order i, f, g, o).

    Returns:
        h: [T, B, H] hidden states (f32, or the act stream's dtype under
        the switch).
    """
    return _layer(_LstmLayer, _lstm_infer, x, iW, b, sW, reverse)


def gru_layer(x, iW, b, sW, reverse=False):
    """Whole GRU layer: h = gru(x @ iW.T + b; sW), direction `reverse`.

    Args:
        x: [T, B, D] f32 (or bf16 under TAIYAKI_TPU_BF16_STREAMS=1); iW:
            [3H, D]; b: [3H]; sW: [3H, H] (gate order r, z, n).

    Returns:
        h: [T, B, H] hidden states (f32, or the act stream's dtype under
        the switch).
    """
    return _layer(_GruLayer, _gru_infer, x, iW, b, sW, reverse)


def _d_sW(dgates, h, reverse):
    """sum over steps of dgates_t^T h_prev_t [G, H]: the recurrent weights'
    gradient, one product over all T*B rows; with bf16 dgates (the scans
    under the switch) the tc atb GEMM's partials of h^T dgates shifted a
    step, summed and transposed (no f32 copy of dgates)."""
    T, B, G = dgates.shape
    H = h.shape[-1]
    if dgates.dtype == torch.bfloat16:
        # h_prev_t = h_{t-1} (h_{t+1} reversed): row k of h meets row k +
        # B (k - B) of dgates
        return atb_gemm(h.reshape(-1, H), dgates.reshape(-1, G),
                        shift=-B if reverse else B).sum(0).t()
    return torch.matmul(dgates.reshape(-1, G).t(),
                        prev_state(h, reverse).reshape(-1, H))


def _gates(gates_x, streams):
    """The scan's gate stream: gates_x in the switch's gx dtype."""
    if streams is None or streams.gx is None:
        return gates_x
    return gates_x.to(streams.gx)


def _scan_dtypes(streams):
    """The scan forward's dtype argument under the switch (none unset)."""
    return {} if streams is None else {"res_dtype": streams.res}


def _grad_stream(dh, streams):
    """dh as the scan's chain reads it: in the switch's gradient dtype."""
    dh = dh.contiguous()
    if streams is None or streams.dh is None:
        return dh
    return dh.to(streams.dh)


class _LstmScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, gates_x, sW, reverse):
        ctx.streams = scan_streams()
        ctx.reverse = reverse
        h, c, pre = lstm_scan_fwd(_gates(gates_x, ctx.streams), sW,
                                  reverse=reverse, residuals=True,
                                  **_scan_dtypes(ctx.streams))
        ctx.save_for_backward(h, c, pre, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        h, c, pre, sW = ctx.saved_tensors
        rev = ctx.reverse
        dpre = lstm_scan_bwd(_grad_stream(dh, ctx.streams), pre, c,
                             prev_state(c, rev), sW, reverse=rev)
        d_sW = _d_sW(dpre, h, rev) if ctx.needs_input_grad[1] else None
        # d gates_x in dh's dtype, as the JAX scan returns it
        return dpre.to(dh.dtype), d_sW, None


class _GruScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, gates_x, sW, reverse):
        ctx.streams = scan_streams()
        ctx.reverse = reverse
        gx = _gates(gates_x, ctx.streams)
        h, gh = gru_scan_fwd(gx, sW, reverse=reverse, residuals=True,
                             **_scan_dtypes(ctx.streams))
        ctx.save_for_backward(h, gx, gh, sW)
        return h

    @staticmethod
    def backward(ctx, dh):
        h, gx, gh, sW = ctx.saved_tensors
        rev = ctx.reverse
        dgx, dgh = gru_scan_bwd(_grad_stream(dh, ctx.streams), gx, gh,
                                prev_state(h, rev), sW, reverse=rev)
        d_sW = _d_sW(dgh, h, rev) if ctx.needs_input_grad[1] else None
        return dgx.to(dh.dtype), d_sW, None


def _scan(fn, forward, gates_x, sW, reverse):
    args = [t.contiguous() for t in (gates_x, sW)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return fn.apply(*args, bool(reverse))
    streams = scan_streams()
    return forward(_gates(args[0], streams), args[1], reverse=reverse,
                   **_scan_dtypes(streams))


def lstm_scan(gates_x, sW, reverse=False):
    """LSTM over time given precomputed input gates.

    Args:
        gates_x: [T, B, 4H] = x @ iW.T + b (torch gate order i,f,g,o).
        sW: [4H, H] recurrent weights.
        reverse: run the recurrence backwards in time (inputs/outputs stay
            in natural time order).

    Returns:
        h: [T, B, H] hidden states, f32 (under TAIYAKI_TPU_BF16_STREAMS=1
        too, as the JAX scan's).
    """
    return _scan(_LstmScan, lstm_scan_fwd, gates_x, sW, reverse)


def gru_scan(gates_x, sW, reverse=False):
    """GRU over time given precomputed input gates.

    Args:
        gates_x: [T, B, 3H] = x @ iW.T + b (CUDNN gate order r,z,n).
        sW: [3H, H] recurrent weights.
        reverse: run the recurrence backwards in time (inputs/outputs stay
            in natural time order).

    Returns:
        h: [T, B, H] hidden states, f32 (under TAIYAKI_TPU_BF16_STREAMS=1
        too, as the JAX scan's).
    """
    return _scan(_GruScan, gru_scan_fwd, gates_x, sW, reverse)
