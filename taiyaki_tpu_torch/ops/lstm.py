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

`lstm_scan_fwd` and `lstm_scan_bwd` are the recurrence on given input
gates without the input product, what pallas_rnn.py:141 `lstm_fwd` and
:726 `lstm_bwd` compute: h (and the residuals c and pre) from gates_x
[T, B, 4H], and the gate gradients dpre (= d gates_x), with iW also d_x.
They run the layer kernels' chains (csrc/lstm.cu).

The forward recurrence (of `lstm_fwd` and `lstm_scan_fwd`) and the
backward chain (of the three backwards and `lstm_scan_bwd`) each have two
instances that compute the same values, the cluster instance and the L2
one; `rnn_plan.rec_plan` (forward) and `rnn_plan.bwd_plan` (backward) pick
one before the launch, by shape and by the clusters the card runs at once
(`clusters_per_wave`), and each wrapper counts its launches per instance
(`<wrapper>.by_instance`).  The keyword `instance=` forces one, for tests
and chip_smoke.py only.

Streams.  Every kernel has an f32 instance, which takes f32 tensors
alone.  The layer forward and the three layer backwards also have a bf16
instance: the JAX package's mixed precision on its accelerator
(taiyaki_tpu/ops/rnn.py:29-42, the port's TAIYAKI_TPU_BF16_STREAMS=1,
ops/rnn.py).  The forward's `res_dtype=torch.bfloat16` takes it: c, pre,
acts and tc come back in bf16, h in `h_dtype` (bf16 or f32), from an x
of f32 or bf16; the arithmetic, the carry and the gx scratch stay f32.
The backwards take it when the residuals (acts and tc, pre and c, or c)
are bf16: they widen every value at load, dh, h and x may each be bf16
or f32, dpre stays f32 and d_x comes back in x's dtype.  The plain twins
take the same dtypes and round exactly where the kernels store.  The
recurrences on given gates have their bf16 instance too, the JAX scans'
mixed precision (taiyaki_tpu/ops/rnn.py:222-257):
`lstm_scan_fwd(res_dtype=torch.bfloat16)` reads gates_x of f32 or bf16 (a
bf16 gate stream through registers) and gives h in f32, c and pre in
bf16; `lstm_scan_bwd` on bf16 pre, c and c_prev reads dh in f32 or bf16
and stores dpre in dh's dtype, the chain going on from the f32 value.  Each wrapper counts its bf16 launches (`<wrapper>.bf16`,
and `<wrapper>.bf16_by_instance`).  A bf16 tensor given to an f32
instance, or a pairing no JAX route produces, raises.

On a CPU tensor the plain PyTorch twin runs; on a CUDA tensor the kernel
launches, or the wrapper raises.
"""

import functools

import torch

from taiyaki_tpu_torch.ops import cuda_lib, gemm, rnn_plan

# the L2 instance of the forward and the backward chains run one thread per
# hidden unit (csrc/lstm.cu)
MAX_HIDDEN = rnn_plan.MAX_HIDDEN
_P, _I = cuda_lib.P, cuda_lib.I
# (the GEMM plans go as one pointer, an int array: ops/gemm.py `c_args`)
_SIGNATURES = {"tt_lstm_fwd": [_P] * 9 + [_I] * 13 + [_P, _P],
               "tt_lstm_bwd": [_P] * 13 + [_I] * 6 + [_P] + [_I] * 7 + [_P],
               "tt_lstm_bwd_recompute": [_P] * 14 + [_I] * 6 + [_P]
               + [_I] * 6 + [_P],
               "tt_lstm_scan_fwd": [_P] * 5 + [_I] * 11 + [_P],
               "tt_lstm_cluster_occupancy": [_I] * 6,
               "tt_lstm_scan_bwd": [_P] * 9 + [_I] * 12 + [_P, _P]}
# the forward's emit modes, in the order csrc/lstm.cu numbers them, and
# the residuals each returns after h
RESIDUALS = {None: (), "c": ("c",), "pre": ("c", "pre"),
             "acts": ("c", "acts", "tc")}
EMITS = tuple(RESIDUALS)
F32, BF16 = torch.float32, torch.bfloat16
# the entry points' `streams` bits (csrc/lstm.cu STREAM_*): x (and d_x;
# the gate stream gx of the scans), h, the residuals (the bf16 instance),
# and dh (with the gradient streams the scans' chains store), in bf16
STREAM_X, STREAM_H, STREAM_RES, STREAM_DH = 1, 2, 4, 8


def lstm_fwd_plain(x, iW, b, sW, reverse=False, emit=None, h_dtype=None,
                   res_dtype=None):
    """Plain PyTorch LSTM forward: x [T, B, D], iW [4H, D], b [4H],
    sW [4H, H] -> h [T, B, H] (gate order i, f, g, o); with emit="c"
    (h, c [T, B, H]); emit="pre" (h, c, pre [T, B, 4H]); emit="acts"
    (h, c, acts [T, B, 4H], tc [T, B, H]).  In f32 on x widened; h comes
    back in `h_dtype` and the residuals in `res_dtype` (f32 by
    default)."""
    keep = RESIDUALS[emit]
    out, res = _lstm_rec_plain(torch.matmul(x.float(), iW.t()) + b, sW,
                               reverse, keep)
    out = _as(out, h_dtype)
    if emit is None:
        return out
    return (out,) + tuple(_as(res[k], res_dtype) for k in keep)


def _as(t, dtype):
    """t in `dtype` (None: as it is), rounded to nearest even for bf16."""
    return t if dtype in (None, t.dtype) else t.to(dtype)


def _lstm_rec_plain(gx, sW, reverse, keep):
    """The recurrence on the input gates gx [T, B, 4H]: (h, {residual:
    stream}) for the residuals named in `keep`."""
    T, B, _ = gx.shape
    H = sW.shape[1]
    h = gx.new_zeros(B, H)
    c = gx.new_zeros(B, H)
    out = gx.new_empty(T, B, H)
    res = {k: gx.new_empty(T, B, 4 * H if k in ("pre", "acts") else H)
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
    return out, res


_check_args = gemm._check


def _streams(what, x, h, res):
    """The `streams` bits of a launch whose x, h and residuals have the
    dtypes given: 0 for all f32 (the f32 instance), else the bf16
    instance's, which needs bf16 residuals."""
    for name, dt in (("x", x), ("h", h), ("the residuals", res)):
        if dt not in (F32, BF16):
            raise ValueError("{}: {} must be float32 or bfloat16, not "
                             "{}".format(what, name, dt))
    if res == F32 and BF16 in (x, h):
        raise ValueError("{}: bf16 x or h takes the bf16 instance, with "
                         "bf16 residuals".format(what))
    return ((STREAM_RES if res == BF16 else 0)
            | (STREAM_X if x == BF16 else 0) | (STREAM_H if h == BF16 else 0))


def _check_hidden(what, H):
    if H > MAX_HIDDEN:
        raise ValueError("{}: hidden size {} > {} is not supported by the "
                         "kernel".format(what, H, MAX_HIDDEN))


def lstm_fwd(x, iW, b, sW, reverse=False, emit=None, instance=None,
             h_dtype=None, res_dtype=None):
    """LSTM layer forward; same contract as `lstm_fwd_plain`.  `instance`
    ("cluster" or "l2") forces an instance of the recurrence on the card,
    for tests and timing; None takes `rnn_plan.rec_plan`'s.
    `res_dtype=torch.bfloat16` takes the bf16 instance (module notes);
    else x and h must be f32."""
    if emit not in EMITS:
        raise ValueError("lstm_fwd: emit must be one of {}".format(EMITS))
    rnn_plan.check_instance(instance)
    h_dtype, res_dtype = h_dtype or F32, res_dtype or F32
    streams = _streams("lstm_fwd", x.dtype, h_dtype, res_dtype)
    if x.device.type == "cpu":
        return lstm_fwd_plain(x, iW, b, sW, reverse, emit, h_dtype,
                              res_dtype)
    cuda_lib.check_cuda(x, "lstm_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("lstm_fwd", x.device, (
        ("x", x, (T, B, D), (F32, BF16)), ("iW", iW, (4 * H, D)),
        ("b", b, (4 * H,)), ("sW", sW, (4 * H, H))))
    _check_hidden("lstm_fwd", H)
    plan = rnn_plan.rec_plan(4, H, B, clusters_per_wave(
        x.device.index), instance)
    gplans = gemm.plans_for(x.device, (T * B, 4 * H, D, gemm.GATE,
                                       x.dtype == BF16))
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = x.device
    with torch.cuda.device(dev):
        x, iW = gemm.tma_ready(x, iW)
        swt = sW.t().contiguous()
        # gx scratch (f32); under emit="pre" the f32 instance gives it back
        # holding pre, the bf16 one writes pre into the acts stream
        gx = torch.empty(T, B, 4 * H, device=dev)
        h = torch.empty(T, B, H, device=dev, dtype=h_dtype)
        c = acts = tc = None
        if emit is not None:
            c = torch.empty(T, B, H, device=dev, dtype=res_dtype)
        if emit == "acts" or (emit == "pre" and res_dtype == BF16):
            acts = torch.empty(T, B, 4 * H, device=dev, dtype=res_dtype)
        if emit == "acts":
            tc = torch.empty(T, B, H, device=dev, dtype=res_dtype)
        err = lib.tt_lstm_fwd(
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(swt), cuda_lib.ptr(gx), cuda_lib.ptr(h),
            cuda_lib.ptr(c), cuda_lib.ptr(acts), cuda_lib.ptr(tc),
            T, B, D, H, int(bool(reverse)), EMITS.index(emit), streams,
            *rnn_plan.c_args(plan), gemm.c_args(gplans),
            cuda_lib.stream(dev))
        rnn_plan.count(lstm_fwd, plan, bool(streams))
        gemm.count(gplans, [bool(streams & STREAM_X)])
    cuda_lib.check(lib, err, "lstm_fwd kernel")
    pre = acts if res_dtype == BF16 else gx
    return {None: h, "c": (h, c), "pre": (h, c, pre),
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
        the weight gradients as one partial each.  Every input is widened
        to f32; d_x comes back in x's dtype, the rest in f32.
    """
    T, B, H = dh.shape
    dpre = _lstm_dpre_plain(dh.float(), acts.float(), tc.float(),
                            c_prev.float(), sW, reverse)
    flat = dpre.reshape(T * B, 4 * H)
    d_x = _as(torch.matmul(dpre, iW), x.dtype)
    d_iW = torch.matmul(flat.t(), x.float().reshape(T * B, -1))
    d_sW = torch.matmul(flat.t(),
                        prev_state(h.float(), reverse).reshape(T * B, H))
    return d_x, d_sW[None], d_iW[None], flat.sum(0)[None]


def _lstm_dpre_plain(dh, acts, tc, c_prev, sW, reverse):
    """The gradient chain: dpre [T, B, 4H] from dh, the activated gates,
    tanh(c) and c_prev, walking opposite to the forward direction."""
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
    return dpre


def _acts_from_pre(pre, c):
    """(acts, tanh(c)) from the pre-activations [T, B, 4H] and c."""
    i, f, g, o = pre.chunk(4, dim=-1)
    return (torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                       torch.sigmoid(o)], dim=-1), torch.tanh(c))


def lstm_bwd_fusedw_plain(dh, pre, c, c_prev, h, x, sW, iW, reverse=False):
    """Plain PyTorch LSTM backward from the stored pre-activations pre
    [T, B, 4H] and c [T, B, H]; the other arguments and the result as
    `lstm_bwd_acts_plain`'s."""
    acts, tc = _acts_from_pre(pre.float(), c.float())
    return lstm_bwd_acts_plain(dh, acts, tc, c_prev, h, x, sW, iW, reverse)


def lstm_bwd_recompute_plain(dh, c, h, x, sW, iW, b, reverse=False):
    """Plain PyTorch LSTM backward from c and h alone: pre = x . iW^T + b +
    h_prev . sW^T is rebuilt in f32 (b [4H]); the other arguments and the
    result as `lstm_bwd_acts_plain`'s."""
    pre = (torch.matmul(x.float(), iW.t()) + b
           + torch.matmul(prev_state(h.float(), reverse), sW.t()))
    return lstm_bwd_fusedw_plain(dh, pre, c, prev_state(c, reverse), h, x,
                                 sW, iW, reverse)


def bwd_outputs(T, B, D, G, H, dev, plan, x_dtype=F32, h_dtype=F32):
    """The outputs of a recurrent backward kernel with G gate rows on
    `plan` (its chain's), (d_x [T, B, D] of x's dtype, d_sW [ns, G, H],
    d_iW [ni, G, D], d_b [ceil(B / plan.BT), G]), and the GEMM plans of
    the three products after the chain (`gemm.chain_plans`, on x and h of
    the dtypes given), whose slices are ni and ns."""
    gplans = gemm.chain_plans(dev, T * B, G, D, H, x_dtype == BF16,
                              h_dtype == BF16)
    return (torch.empty(T, B, D, device=dev, dtype=x_dtype),
            torch.empty(gplans[2].nsplit, G, H, device=dev),
            torch.empty(gplans[1].nsplit, G, D, device=dev),
            torch.empty(-(-B // plan.BT), G, device=dev)), gplans


def _bwd_plan(H, B, device, instance, ring16=False):
    """The backward chain's plan on `device` (`rnn_plan.bwd_plan` on the
    card's clusters a wave; `ring16` for the bf16 instance, whose ring
    holds bf16 words)."""
    return rnn_plan.bwd_plan(4, H, B, clusters_per_wave(device.index),
                             instance, ring16)


def _bwd_streams(what, residuals, dh, h=None, x=None):
    """The `streams` bits of a backward chain: the bf16 instance where the
    residuals (a list of tensors, all of one dtype) are bf16, beside which
    dh, h (h_prev) and x (the scans' gate stream) may each be bf16 or f32;
    the f32 instance takes f32 alone.  A scan's chain stores its gradient
    streams in dh's dtype."""
    res = {t.dtype for t in residuals}
    if len(res) != 1 or not res <= {F32, BF16}:
        raise ValueError("{}: the residuals must share one dtype, float32 "
                         "or bfloat16 (got {})".format(
                             what, sorted(map(str, res))))
    streams = STREAM_RES if res == {BF16} else 0
    for name, t, bit in (("dh", dh, STREAM_DH), ("h", h, STREAM_H),
                         ("x", x, STREAM_X)):
        if t is None:
            continue
        if t.dtype not in (F32, BF16) or (t.dtype == BF16 and not streams):
            raise ValueError("{}: {} must be float32, or bfloat16 beside "
                             "bf16 residuals (got {})".format(what, name,
                                                              t.dtype))
        streams |= bit if t.dtype == BF16 else 0
    return streams


def _lstm_bwd_stored(fn, from_pre, dh, gates, cs, c_prev, h, x, sW, iW,
                     reverse, instance):
    """tt_lstm_bwd for the wrapper `fn`: the backward from stored acts and
    tanh(c) (from_pre 0) or pre and c (from_pre 1), its chain on
    `rnn_plan.bwd_plan`'s instance (or the forced `instance`)."""
    what = fn.__name__
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    streams = _bwd_streams(what, (gates, cs, c_prev), dh, h, x)
    both = (F32, BF16)
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H), both),
        ("pre" if from_pre else "acts", gates, (T, B, 4 * H), both),
        ("c" if from_pre else "tc", cs, (T, B, H), both),
        ("c_prev", c_prev, (T, B, H), both), ("h", h, (T, B, H), both),
        ("x", x, (T, B, D), both), ("sW", sW, (4 * H, H)),
        ("iW", iW, (4 * H, D))))
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance, bool(streams))
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, h, iwt = gemm.tma_ready(x, h, iW.t().contiguous())
        dh, gates, cs, c_prev = rnn_plan.ring_ready(
            plan, H, bool(streams), dh, gates, cs, c_prev)
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 4 * H, H, dev, plan, x.dtype,
                                  h.dtype)
        err = lib.tt_lstm_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(gates), cuda_lib.ptr(cs),
            cuda_lib.ptr(c_prev), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(dpre),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            streams, gemm.c_args(gplans), from_pre, *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(fn, plan, bool(streams))
        gemm.count(gplans, _chain_bf16(streams))
    cuda_lib.check(lib, err, what + " kernel")
    return out


def _chain_bf16(streams):
    """Which of a backward's three products after its chain (d_x, d_iW,
    d_sW) have a bf16 operand or output."""
    return [bool(streams & STREAM_X)] * 2 + [bool(streams & STREAM_H)]


def lstm_bwd_acts(dh, acts, tc, c_prev, h, x, sW, iW, reverse=False,
                  instance=None):
    """LSTM layer backward; contract of `lstm_bwd_acts_plain`, except that
    the kernel returns d_sW and d_iW as [nsplit, ...] partials over slices
    of the T*B rows and d_b as [ceil(B / BT), 4H] partials over the chain
    plan's batch tiles; the caller sums them.  `instance` ("cluster" or
    "l2") forces an instance of the chain on the card, for tests and
    timing; None takes `rnn_plan.bwd_plan`'s."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        _bwd_streams("lstm_bwd_acts", (acts, tc, c_prev), dh, h, x)
        return lstm_bwd_acts_plain(dh, acts, tc, c_prev, h, x, sW, iW,
                                   reverse)
    return _lstm_bwd_stored(lstm_bwd_acts, 0, dh, acts, tc, c_prev, h, x,
                            sW, iW, reverse, instance)


def lstm_bwd_fusedw(dh, pre, c, c_prev, h, x, sW, iW, reverse=False,
                    instance=None):
    """LSTM layer backward from the stored pre-activations; contract of
    `lstm_bwd_fusedw_plain`, with the partials and `instance` of
    `lstm_bwd_acts`."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        _bwd_streams("lstm_bwd_fusedw", (pre, c, c_prev), dh, h, x)
        return lstm_bwd_fusedw_plain(dh, pre, c, c_prev, h, x, sW, iW,
                                     reverse)
    return _lstm_bwd_stored(lstm_bwd_fusedw, 1, dh, pre, c, c_prev, h, x,
                            sW, iW, reverse, instance)


def lstm_bwd_recompute(dh, c, h, x, sW, iW, b, reverse=False,
                       instance=None):
    """LSTM layer backward rebuilding pre; contract of
    `lstm_bwd_recompute_plain`, with the partials and `instance` of
    `lstm_bwd_acts`."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        _bwd_streams("lstm_bwd_recompute", (c,), dh, h, x)
        return lstm_bwd_recompute_plain(dh, c, h, x, sW, iW, b, reverse)
    what = "lstm_bwd_recompute"
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    streams = _bwd_streams(what, (c,), dh, h, x)
    both = (F32, BF16)
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H), both), ("c", c, (T, B, H), both),
        ("h", h, (T, B, H), both), ("x", x, (T, B, D), both),
        ("sW", sW, (4 * H, H)), ("iW", iW, (4 * H, D)), ("b", b, (4 * H,))))
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance, bool(streams))
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, iW, h, sW, iwt = gemm.tma_ready(x, iW, h, sW,
                                           iW.t().contiguous())
        dh, c = rnn_plan.ring_ready(plan, H, bool(streams), dh, c)
        pre = torch.empty(T, B, 4 * H, device=dev)
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 4 * H, H, dev, plan, x.dtype,
                                  h.dtype)
        # pre = x iW^T + b, then += h_prev sW^T on all but the boundary step
        gplans = gemm.plans_for(
            dev, (T * B, 4 * H, D, gemm.GATE, x.dtype == BF16),
            ((T - 1) * B, 4 * H, H, gemm.GATE, h.dtype == BF16)) + gplans
        err = lib.tt_lstm_bwd_recompute(
            cuda_lib.ptr(dh), cuda_lib.ptr(c), cuda_lib.ptr(h),
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(pre),
            cuda_lib.ptr(dpre), *map(cuda_lib.ptr, out), T, B, D, H,
            int(bool(reverse)), streams, gemm.c_args(gplans),
            *rnn_plan.c_args(plan), cuda_lib.stream(dev))
        rnn_plan.count(lstm_bwd_recompute, plan, bool(streams))
        bf = ([bool(streams & STREAM_X), bool(streams & STREAM_H)]
              + _chain_bf16(streams))
        if T > 1:
            gemm.count(gplans, bf)
        else:
            gemm.count(gplans[:1] + gplans[2:], bf[:1] + bf[2:])
    cuda_lib.check(lib, err, what + " kernel")
    return out


def lstm_scan_fwd_plain(gates_x, sW, reverse=False, residuals=False,
                        res_dtype=None):
    """Plain PyTorch LSTM recurrence on given input gates gates_x [T, B,
    4H] (= x . iW^T + b, gate order i, f, g, o; f32 or bf16, widened),
    sW [4H, H] -> h [T, B, H] (f32); with residuals (h, c [T, B, H], pre
    [T, B, 4H]), c and pre rounded to `res_dtype` (f32 by default) where
    the kernel stores them, the carry going on in f32."""
    out, res = _lstm_rec_plain(gates_x.float(), sW, reverse,
                               ("c", "pre") if residuals else ())
    if not residuals:
        return out
    return out, _as(res["c"], res_dtype), _as(res["pre"], res_dtype)


def lstm_scan_fwd(gates_x, sW, reverse=False, residuals=False,
                  instance=None, res_dtype=None):
    """The LSTM recurrence on given gates (kernel 14); contract of
    `lstm_scan_fwd_plain`.  gates_x is read, never written.
    `res_dtype=torch.bfloat16` takes the bf16 instance, on gates_x of f32
    or bf16 (the JAX scans' mixed precision: h f32, c and pre bf16); else
    gates_x must be f32.  `instance` as `lstm_fwd`'s."""
    rnn_plan.check_instance(instance)
    what = "lstm_scan_fwd"
    res_dtype = res_dtype or F32
    streams = _streams(what, gates_x.dtype, F32, res_dtype)
    if gates_x.device.type == "cpu":
        return lstm_scan_fwd_plain(gates_x, sW, reverse, residuals,
                                   res_dtype)
    cuda_lib.check_cuda(gates_x, what)
    T, B = gates_x.shape[:2]
    H = sW.shape[1]
    _check_args(what, gates_x.device, (
        ("gates_x", gates_x, (T, B, 4 * H), (F32, BF16)),
        ("sW", sW, (4 * H, H))))
    _check_hidden(what, H)
    plan = rnn_plan.rec_plan(4, H, B, clusters_per_wave(
        gates_x.device.index), instance)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = gates_x.device
    with torch.cuda.device(dev):
        swt = sW.t().contiguous()
        h = torch.empty(T, B, H, device=dev)
        c = pre = None
        if residuals:
            c = torch.empty(T, B, H, device=dev, dtype=res_dtype)
            pre = torch.empty(T, B, 4 * H, device=dev, dtype=res_dtype)
        err = lib.tt_lstm_scan_fwd(
            cuda_lib.ptr(gates_x), cuda_lib.ptr(swt), cuda_lib.ptr(pre),
            cuda_lib.ptr(h), cuda_lib.ptr(c), T, B, H, int(bool(reverse)),
            streams, *rnn_plan.c_args(plan), cuda_lib.stream(dev))
        rnn_plan.count(lstm_scan_fwd, plan, bool(streams))
    cuda_lib.check(lib, err, what + " kernel")
    return (h, c, pre) if residuals else h


def lstm_scan_bwd_plain(dh, pre, c, c_prev, sW, reverse=False, iW=None):
    """Plain PyTorch LSTM gradient chain on the recurrence's residuals:
    dh, c, c_prev [T, B, H], pre [T, B, 4H], sW [4H, H] -> dpre [T, B, 4H]
    (= d gates_x), each input widened, dpre rounded to dh's dtype where
    the kernel stores it, the chain going on from the f32 value; with iW
    [4H, D] (dpre, d_x = dpre . iW [T, B, D], f32, from the stored dpre).  `reverse` is the forward's direction; the chain
    walks opposite."""
    acts, tc = _acts_from_pre(pre.float(), c.float())
    dpre = _as(_lstm_dpre_plain(dh.float(), acts, tc, c_prev.float(), sW,
                                reverse), dh.dtype)
    return dpre if iW is None else (dpre, torch.matmul(dpre.float(), iW))


def lstm_scan_bwd(dh, pre, c, c_prev, sW, reverse=False, iW=None,
                  instance=None):
    """The LSTM gradient chain on given gates (kernel 15); contract of
    `lstm_scan_bwd_plain`.  bf16 pre, c and c_prev take the bf16
    instance, with dh, and so the stored dpre, bf16 or f32; f32 ones the
    f32 instance, all f32.  `instance` as
    `lstm_bwd_acts`'s."""
    rnn_plan.check_instance(instance)
    what = "lstm_scan_bwd"
    streams = _bwd_streams(what, (pre, c, c_prev), dh)
    if dh.device.type == "cpu":
        return lstm_scan_bwd_plain(dh, pre, c, c_prev, sW, reverse, iW)
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    both = (F32, BF16)
    specs = [("dh", dh, (T, B, H), both), ("pre", pre, (T, B, 4 * H), both),
             ("c", c, (T, B, H), both), ("c_prev", c_prev, (T, B, H), both),
             ("sW", sW, (4 * H, H))]
    D = 0 if iW is None else iW.shape[1]
    if iW is not None:
        specs.append(("iW", iW, (4 * H, D)))
    _check_args(what, dh.device, specs)
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance, bool(streams))
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt, = gemm.tma_ready(None if iW is None else iW.t().contiguous())
        dh, pre, c, c_prev = rnn_plan.ring_ready(plan, H, bool(streams), dh,
                                                 pre, c, c_prev)
        dpre = torch.empty(T, B, 4 * H, device=dev, dtype=dh.dtype)
        d_x = None if iW is None else torch.empty(T, B, D, device=dev)
        db = torch.empty(-(-B // plan.BT), 4 * H, device=dev)
        gplans = ([] if iW is None else gemm.plans_for(
            dev, (T * B, D, 4 * H, gemm.GATE, dh.dtype == BF16)))
        err = lib.tt_lstm_scan_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(pre), cuda_lib.ptr(c),
            cuda_lib.ptr(c_prev), cuda_lib.ptr(sW), cuda_lib.ptr(iwt),
            cuda_lib.ptr(dpre), cuda_lib.ptr(d_x), cuda_lib.ptr(db), T, B,
            D, H, int(bool(reverse)), streams, *rnn_plan.c_args(plan),
            gemm.c_args(gplans), cuda_lib.stream(dev))
        rnn_plan.count(lstm_scan_bwd, plan, bool(streams))
        gemm.count(gplans, [dh.dtype == BF16])
    cuda_lib.check(lib, err, what + " kernel")
    return dpre if iW is None else (dpre, d_x)


def cluster_occupancy(H, plan):
    """How many clusters of the cluster instance's `plan` for H units the
    card runs at once (cudaOccupancyMaxActiveClusters), on the current
    CUDA device."""
    lib = cuda_lib.load("lstm", _SIGNATURES)
    n = lib.tt_lstm_cluster_occupancy(H, plan.C, plan.BT, plan.RB,
                                       plan.KS, plan.smem)
    cuda_lib.check(lib, -min(n, 0), "tt_lstm_cluster_occupancy")
    return n


@functools.lru_cache(maxsize=None)
def clusters_per_wave(index):
    """How many clusters of each of rnn_plan.CLUSTER_SIZES CUDA device
    `index` runs at once (`rnn_plan.clusters_per_wave`), read from the
    card once: the plans fill that card, whatever its SMs and GPCs."""
    with torch.cuda.device(index):
        return rnn_plan.clusters_per_wave(cluster_occupancy)


for _fn in (lstm_fwd, lstm_scan_fwd, lstm_scan_bwd, lstm_bwd_acts,
            lstm_bwd_fusedw, lstm_bwd_recompute):
    _fn.launches = 0
    _fn.by_instance = rnn_plan.instance_counters()
for _fn in (lstm_fwd, lstm_scan_fwd, lstm_scan_bwd, lstm_bwd_acts,
            lstm_bwd_fusedw, lstm_bwd_recompute):
    _fn.bf16 = rnn_plan.Launches()
    _fn.bf16_by_instance = rnn_plan.instance_counters()
