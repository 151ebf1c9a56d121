"""LSTM layer forward and backwards: the CUDA kernels (csrc/lstm.cu) and
their plain twins.

`lstm_fwd` computes what the TPU kernel
taiyaki_tpu/ops/pallas_rnn.py:880 `lstm_fused_fwd` computes: the hidden
states of one LSTM layer, the input product x . iW^T + b included, in f32,
and beside them the residuals of one of the backwards (`emit`): c, for
`lstm_bwd_recompute`; c and the pre-activations pre, for
`lstm_bwd_fusedw`; c, acts = [i|f|g|o] (the gates after their
activations) and tc = tanh(c), for `lstm_bwd_acts`.  The three backwards
compute what the TPU kernels of their names compute (pallas_rnn.py:385,
:456, :625): d_x and the weight gradients as partial sums over slices of
the batch and time, which the caller adds up.  The port takes any T as it
is (no time padding, so no masked tail rows); `reverse` walks time
backwards and keeps the outputs in natural order.

On a CPU tensor the plain PyTorch twin runs; on a CUDA tensor the kernel
launches, or the wrapper raises.
"""

import torch

from taiyaki_tpu_torch.ops import cuda_lib

# the recurrences run one thread per hidden unit (csrc/lstm.cu)
MAX_HIDDEN = 512
# batch rows per block of the recurrence kernels: d_b comes back as one
# partial per tile of this many rows
BATCH_TILE = 8
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_lstm_fwd": [_P] * 9 + [_I] * 6 + [_P],
               "tt_lstm_bwd": [_P] * 13 + [_I] * 7 + [_P],
               "tt_lstm_bwd_recompute": [_P] * 14 + [_I] * 6 + [_P]}
# the forward's emit modes, in the order csrc/lstm.cu numbers them, and
# the residuals each returns after h
RESIDUALS = {None: (), "c": ("c",), "pre": ("c", "pre"),
             "acts": ("c", "acts", "tc")}
EMITS = tuple(RESIDUALS)


def lstm_fwd_plain(x, iW, b, sW, reverse=False, emit=None):
    """Plain PyTorch LSTM forward: x [T, B, D], iW [4H, D], b [4H],
    sW [4H, H] -> h [T, B, H] (gate order i, f, g, o); with emit="c"
    (h, c [T, B, H]); emit="pre" (h, c, pre [T, B, 4H]); emit="acts"
    (h, c, acts [T, B, 4H], tc [T, B, H])."""
    T, B, _ = x.shape
    H = sW.shape[1]
    gx = torch.matmul(x, iW.t()) + b
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = x.new_empty(T, B, H)
    keep = RESIDUALS[emit]
    res = {k: x.new_empty(T, B, 4 * H if k in ("pre", "acts") else H)
           for k in keep}
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        pre = gx[t] + torch.matmul(h, sW.t())
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:])
        c = f * c + i * g
        tc = torch.tanh(c)
        h = o * tc
        out[t] = h
        step = {"c": c, "pre": pre, "tc": tc}
        if "acts" in res:
            step["acts"] = torch.cat([i, f, g, o], dim=1)
        for k in keep:
            res[k][t] = step[k]
    if emit is None:
        return out
    return (out,) + tuple(res[k] for k in keep)


def _check_args(what, device, specs):
    for name, t, shape in specs:
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                "{}: {} must be a contiguous float32 tensor of shape {} on "
                "{} (got {} {} {})".format(what, name, tuple(shape), device,
                                           t.dtype, tuple(t.shape), t.device))


def _check_hidden(what, H):
    if H > MAX_HIDDEN:
        raise ValueError("{}: hidden size {} > {} is not supported by the "
                         "kernel".format(what, H, MAX_HIDDEN))


def lstm_fwd(x, iW, b, sW, reverse=False, emit=None):
    """LSTM layer forward; same contract as `lstm_fwd_plain`."""
    if emit not in EMITS:
        raise ValueError("lstm_fwd: emit must be one of {}".format(EMITS))
    if x.device.type == "cpu":
        return lstm_fwd_plain(x, iW, b, sW, reverse, emit)
    cuda_lib.check_cuda(x, "lstm_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("lstm_fwd", x.device, (
        ("x", x, (T, B, D)), ("iW", iW, (4 * H, D)), ("b", b, (4 * H,)),
        ("sW", sW, (4 * H, H))))
    _check_hidden("lstm_fwd", H)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    with torch.cuda.device(x.device):
        swt = sW.t().contiguous()
        # gx scratch; under emit="pre" it comes back holding pre
        gx = torch.empty(T, B, 4 * H, device=x.device)
        h = torch.empty(T, B, H, device=x.device)
        c = acts = tc = None
        if emit is not None:
            c = torch.empty(T, B, H, device=x.device)
        if emit == "acts":
            acts = torch.empty(T, B, 4 * H, device=x.device)
            tc = torch.empty(T, B, H, device=x.device)
        err = lib.tt_lstm_fwd(
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(swt), cuda_lib.ptr(gx), cuda_lib.ptr(h),
            cuda_lib.ptr(c), cuda_lib.ptr(acts), cuda_lib.ptr(tc),
            T, B, D, H, int(bool(reverse)), EMITS.index(emit),
            cuda_lib.stream(x.device))
        lstm_fwd.launches += 1
    cuda_lib.check(lib, err, "lstm_fwd kernel")
    return {None: h, "c": (h, c), "pre": (h, c, gx),
            "acts": (h, c, acts, tc)}[emit]


def prev_state(x, reverse):
    """States entering each step: x[t-1] for a forward walk, x[t+1] for a
    reversed one, zero at the boundary (ops/rnn.py:187-196 of the JAX
    package)."""
    zero = x.new_zeros((1,) + tuple(x.shape[1:]))
    if reverse:
        return torch.cat([x[1:], zero])
    return torch.cat([zero, x[:-1]])


def lstm_bwd_acts_plain(dh, acts, tc, c_prev, h, x, sW, iW, reverse=False):
    """Plain PyTorch LSTM backward from stored activations.

    Args:
        dh: [T, B, H] gradient of the layer's output h.
        acts: [T, B, 4H] gates after their activations; tc: [T, B, H]
            tanh(c); c_prev: [T, B, H] cell state entering each step;
            h: [T, B, H] hidden states; x: [T, B, D] layer input.
        sW: [4H, H]; iW: [4H, D].

    Returns:
        (d_x [T, B, D], d_sW [1, 4H, H], d_iW [1, 4H, D], d_b [1, 4H]):
        the weight gradients as one partial each.
    """
    T, B, H = dh.shape
    dpre = dh.new_empty(T, B, 4 * H)
    dh_c = dh.new_zeros(B, H)
    dc_c = dh.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = acts[t].split(H, dim=1)
        tct = tc[t]
        dht = dh[t] + dh_c
        d_o = dht * tct
        dc = dht * o * (1.0 - tct * tct) + dc_c
        dpre[t] = torch.cat([dc * g * i * (1.0 - i),
                             dc * c_prev[t] * f * (1.0 - f),
                             dc * i * (1.0 - g * g),
                             d_o * o * (1.0 - o)], dim=1)
        dh_c = torch.matmul(dpre[t], sW)
        dc_c = dc * f
    flat = dpre.reshape(T * B, 4 * H)
    d_x = torch.matmul(dpre, iW)
    d_iW = torch.matmul(flat.t(), x.reshape(T * B, -1))
    d_sW = torch.matmul(flat.t(), prev_state(h, reverse).reshape(T * B, H))
    return d_x, d_sW[None], d_iW[None], flat.sum(0)[None]


def _acts_from_pre(pre, c):
    """(acts, tanh(c)) from the pre-activations [T, B, 4H] and c."""
    i, f, g, o = pre.chunk(4, dim=-1)
    return (torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                       torch.sigmoid(o)], dim=-1), torch.tanh(c))


def lstm_bwd_fusedw_plain(dh, pre, c, c_prev, h, x, sW, iW, reverse=False):
    """Plain PyTorch LSTM backward from the stored pre-activations pre
    [T, B, 4H] and c [T, B, H]; the other arguments and the result as
    `lstm_bwd_acts_plain`'s."""
    acts, tc = _acts_from_pre(pre, c)
    return lstm_bwd_acts_plain(dh, acts, tc, c_prev, h, x, sW, iW, reverse)


def lstm_bwd_recompute_plain(dh, c, h, x, sW, iW, b, reverse=False):
    """Plain PyTorch LSTM backward from c and h alone: pre = x . iW^T + b +
    h_prev . sW^T is rebuilt (b [4H]); the other arguments and the result
    as `lstm_bwd_acts_plain`'s."""
    pre = (torch.matmul(x, iW.t()) + b
           + torch.matmul(prev_state(h, reverse), sW.t()))
    return lstm_bwd_fusedw_plain(dh, pre, c, prev_state(c, reverse), h, x,
                                 sW, iW, reverse)


def _nsplit(rows):
    """Slices of the T*B reduction of the weight-gradient products: enough
    blocks to fill the card, each slice at least 2048 rows long."""
    return max(1, min(32, rows // 2048))


def bwd_outputs(T, B, D, G, H, dev):
    """The outputs of a recurrent backward kernel with G gate rows, (d_x
    [T, B, D], d_sW [nsplit, G, H], d_iW [nsplit, G, D], d_b [ceil(B/8),
    G]), and nsplit."""
    nsplit = _nsplit(T * B)
    return (torch.empty(T, B, D, device=dev),
            torch.empty(nsplit, G, H, device=dev),
            torch.empty(nsplit, G, D, device=dev),
            torch.empty(-(-B // BATCH_TILE), G, device=dev)), nsplit


def _lstm_bwd_stored(fn, from_pre, dh, gates, cs, c_prev, h, x, sW, iW,
                     reverse):
    """tt_lstm_bwd for the wrapper `fn`: the backward from stored acts and
    tanh(c) (from_pre 0) or pre and c (from_pre 1)."""
    what = fn.__name__
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H)),
        ("pre" if from_pre else "acts", gates, (T, B, 4 * H)),
        ("c" if from_pre else "tc", cs, (T, B, H)),
        ("c_prev", c_prev, (T, B, H)), ("h", h, (T, B, H)),
        ("x", x, (T, B, D)), ("sW", sW, (4 * H, H)), ("iW", iW, (4 * H, D))))
    _check_hidden(what, H)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt = iW.t().contiguous()
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, nsplit = bwd_outputs(T, B, D, 4 * H, H, dev)
        err = lib.tt_lstm_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(gates), cuda_lib.ptr(cs),
            cuda_lib.ptr(c_prev), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(dpre),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)), nsplit,
            from_pre, cuda_lib.stream(dev))
        fn.launches += 1
    cuda_lib.check(lib, err, what + " kernel")
    return out


def lstm_bwd_acts(dh, acts, tc, c_prev, h, x, sW, iW, reverse=False):
    """LSTM layer backward; contract of `lstm_bwd_acts_plain`, except that
    the kernel returns d_sW and d_iW as [nsplit, ...] partials over slices
    of the T*B rows and d_b as [ceil(B/8), 4H] partials over batch tiles;
    the caller sums them."""
    if dh.device.type == "cpu":
        return lstm_bwd_acts_plain(dh, acts, tc, c_prev, h, x, sW, iW,
                                   reverse)
    return _lstm_bwd_stored(lstm_bwd_acts, 0, dh, acts, tc, c_prev, h, x,
                            sW, iW, reverse)


def lstm_bwd_fusedw(dh, pre, c, c_prev, h, x, sW, iW, reverse=False):
    """LSTM layer backward from the stored pre-activations; contract of
    `lstm_bwd_fusedw_plain`, with the partials of `lstm_bwd_acts`."""
    if dh.device.type == "cpu":
        return lstm_bwd_fusedw_plain(dh, pre, c, c_prev, h, x, sW, iW,
                                     reverse)
    return _lstm_bwd_stored(lstm_bwd_fusedw, 1, dh, pre, c, c_prev, h, x,
                            sW, iW, reverse)


def lstm_bwd_recompute(dh, c, h, x, sW, iW, b, reverse=False):
    """LSTM layer backward rebuilding pre; contract of
    `lstm_bwd_recompute_plain`, with the partials of `lstm_bwd_acts`."""
    if dh.device.type == "cpu":
        return lstm_bwd_recompute_plain(dh, c, h, x, sW, iW, b, reverse)
    what = "lstm_bwd_recompute"
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H)), ("c", c, (T, B, H)), ("h", h, (T, B, H)),
        ("x", x, (T, B, D)), ("sW", sW, (4 * H, H)), ("iW", iW, (4 * H, D)),
        ("b", b, (4 * H,))))
    _check_hidden(what, H)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt = iW.t().contiguous()
        pre = torch.empty(T, B, 4 * H, device=dev)
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, nsplit = bwd_outputs(T, B, D, 4 * H, H, dev)
        err = lib.tt_lstm_bwd_recompute(
            cuda_lib.ptr(dh), cuda_lib.ptr(c), cuda_lib.ptr(h),
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(pre),
            cuda_lib.ptr(dpre), *map(cuda_lib.ptr, out), T, B, D, H,
            int(bool(reverse)), nsplit, cuda_lib.stream(dev))
        lstm_bwd_recompute.launches += 1
    cuda_lib.check(lib, err, what + " kernel")
    return out


lstm_fwd.launches = 0
lstm_bwd_acts.launches = 0
lstm_bwd_fusedw.launches = 0
lstm_bwd_recompute.launches = 0
