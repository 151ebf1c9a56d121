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
_SIGNATURES = {"tt_lstm_fwd": [_P] * 9 + [_I] * 12 + [_P, _P],
               "tt_lstm_bwd": [_P] * 13 + [_I] * 5 + [_P] + [_I] * 7 + [_P],
               "tt_lstm_bwd_recompute": [_P] * 14 + [_I] * 5 + [_P]
               + [_I] * 6 + [_P],
               "tt_lstm_scan_fwd": [_P] * 5 + [_I] * 10 + [_P],
               "tt_lstm_cluster_occupancy": [_I] * 6,
               "tt_lstm_scan_bwd": [_P] * 9 + [_I] * 11 + [_P, _P]}
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
    keep = RESIDUALS[emit]
    out, res = _lstm_rec_plain(torch.matmul(x, iW.t()) + b, sW, reverse,
                               keep)
    if emit is None:
        return out
    return (out,) + tuple(res[k] for k in keep)


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


def lstm_fwd(x, iW, b, sW, reverse=False, emit=None, instance=None):
    """LSTM layer forward; same contract as `lstm_fwd_plain`.  `instance`
    ("cluster" or "l2") forces an instance of the recurrence on the card,
    for tests and timing; None takes `rnn_plan.rec_plan`'s."""
    if emit not in EMITS:
        raise ValueError("lstm_fwd: emit must be one of {}".format(EMITS))
    rnn_plan.check_instance(instance)
    if x.device.type == "cpu":
        return lstm_fwd_plain(x, iW, b, sW, reverse, emit)
    cuda_lib.check_cuda(x, "lstm_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("lstm_fwd", x.device, (
        ("x", x, (T, B, D)), ("iW", iW, (4 * H, D)), ("b", b, (4 * H,)),
        ("sW", sW, (4 * H, H))))
    _check_hidden("lstm_fwd", H)
    plan = rnn_plan.rec_plan(4, H, B, clusters_per_wave(
        x.device.index), instance)
    gplans = gemm.plans_for(x.device, (T * B, 4 * H, D, gemm.GATE))
    lib = cuda_lib.load("lstm", _SIGNATURES)
    with torch.cuda.device(x.device):
        x, iW = gemm.tma_ready(x, iW)
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
            *rnn_plan.c_args(plan), gemm.c_args(gplans),
            cuda_lib.stream(x.device))
        rnn_plan.count(lstm_fwd, plan)
        gemm.count(gplans)
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
    dpre = _lstm_dpre_plain(dh, acts, tc, c_prev, sW, reverse)
    flat = dpre.reshape(T * B, 4 * H)
    d_x = torch.matmul(dpre, iW)
    d_iW = torch.matmul(flat.t(), x.reshape(T * B, -1))
    d_sW = torch.matmul(flat.t(), prev_state(h, reverse).reshape(T * B, H))
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


def bwd_outputs(T, B, D, G, H, dev, plan):
    """The outputs of a recurrent backward kernel with G gate rows on
    `plan` (its chain's), (d_x [T, B, D], d_sW [ns, G, H], d_iW [ni, G,
    D], d_b [ceil(B / plan.BT), G]), and the GEMM plans of the three
    products after the chain (`gemm.chain_plans`), whose slices are ni and
    ns."""
    gplans = gemm.chain_plans(dev, T * B, G, D, H)
    return (torch.empty(T, B, D, device=dev),
            torch.empty(gplans[2].nsplit, G, H, device=dev),
            torch.empty(gplans[1].nsplit, G, D, device=dev),
            torch.empty(-(-B // plan.BT), G, device=dev)), gplans


def _bwd_plan(H, B, device, instance):
    """The backward chain's plan on `device` (`rnn_plan.bwd_plan` on the
    card's clusters a wave)."""
    return rnn_plan.bwd_plan(4, H, B, clusters_per_wave(device.index),
                             instance)


def _lstm_bwd_stored(fn, from_pre, dh, gates, cs, c_prev, h, x, sW, iW,
                     reverse, instance):
    """tt_lstm_bwd for the wrapper `fn`: the backward from stored acts and
    tanh(c) (from_pre 0) or pre and c (from_pre 1), its chain on
    `rnn_plan.bwd_plan`'s instance (or the forced `instance`)."""
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
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, h, iwt = gemm.tma_ready(x, h, iW.t().contiguous())
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 4 * H, H, dev, plan)
        err = lib.tt_lstm_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(gates), cuda_lib.ptr(cs),
            cuda_lib.ptr(c_prev), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(dpre),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            gemm.c_args(gplans), from_pre, *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(fn, plan)
        gemm.count(gplans)
    cuda_lib.check(lib, err, what + " kernel")
    return out


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
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, iW, h, sW, iwt = gemm.tma_ready(x, iW, h, sW,
                                           iW.t().contiguous())
        pre = torch.empty(T, B, 4 * H, device=dev)
        dpre = torch.empty(T, B, 4 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 4 * H, H, dev, plan)
        # pre = x iW^T + b, then += h_prev sW^T on all but the boundary step
        gplans = gemm.plans_for(dev, (T * B, 4 * H, D, gemm.GATE),
                                ((T - 1) * B, 4 * H, H, gemm.GATE)) + gplans
        err = lib.tt_lstm_bwd_recompute(
            cuda_lib.ptr(dh), cuda_lib.ptr(c), cuda_lib.ptr(h),
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(sW), cuda_lib.ptr(iwt), cuda_lib.ptr(pre),
            cuda_lib.ptr(dpre), *map(cuda_lib.ptr, out), T, B, D, H,
            int(bool(reverse)), gemm.c_args(gplans), *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(lstm_bwd_recompute, plan)
        gemm.count(gplans if T > 1 else gplans[:1] + gplans[2:])
    cuda_lib.check(lib, err, what + " kernel")
    return out


def lstm_scan_fwd_plain(gates_x, sW, reverse=False, residuals=False):
    """Plain PyTorch LSTM recurrence on given input gates gates_x [T, B,
    4H] (= x . iW^T + b, gate order i, f, g, o), sW [4H, H] -> h [T, B, H];
    with residuals (h, c [T, B, H], pre [T, B, 4H])."""
    out, res = _lstm_rec_plain(gates_x, sW, reverse,
                               ("c", "pre") if residuals else ())
    return (out, res["c"], res["pre"]) if residuals else out


def lstm_scan_fwd(gates_x, sW, reverse=False, residuals=False,
                  instance=None):
    """The LSTM recurrence on given gates (kernel 14); contract of
    `lstm_scan_fwd_plain`.  gates_x is read, never written.  `instance`
    as `lstm_fwd`'s."""
    rnn_plan.check_instance(instance)
    if gates_x.device.type == "cpu":
        return lstm_scan_fwd_plain(gates_x, sW, reverse, residuals)
    what = "lstm_scan_fwd"
    cuda_lib.check_cuda(gates_x, what)
    T, B = gates_x.shape[:2]
    H = sW.shape[1]
    _check_args(what, gates_x.device, (
        ("gates_x", gates_x, (T, B, 4 * H)), ("sW", sW, (4 * H, H))))
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
            c = torch.empty(T, B, H, device=dev)
            pre = torch.empty(T, B, 4 * H, device=dev)
        err = lib.tt_lstm_scan_fwd(
            cuda_lib.ptr(gates_x), cuda_lib.ptr(swt), cuda_lib.ptr(pre),
            cuda_lib.ptr(h), cuda_lib.ptr(c), T, B, H, int(bool(reverse)),
            *rnn_plan.c_args(plan), cuda_lib.stream(dev))
        rnn_plan.count(lstm_scan_fwd, plan)
    cuda_lib.check(lib, err, what + " kernel")
    return (h, c, pre) if residuals else h


def lstm_scan_bwd_plain(dh, pre, c, c_prev, sW, reverse=False, iW=None):
    """Plain PyTorch LSTM gradient chain on the recurrence's residuals:
    dh, c, c_prev [T, B, H], pre [T, B, 4H], sW [4H, H] -> dpre [T, B, 4H]
    (= d gates_x); with iW [4H, D] (dpre, d_x = dpre . iW [T, B, D]).
    `reverse` is the forward's direction; the chain walks opposite."""
    acts, tc = _acts_from_pre(pre, c)
    dpre = _lstm_dpre_plain(dh, acts, tc, c_prev, sW, reverse)
    return dpre if iW is None else (dpre, torch.matmul(dpre, iW))


def lstm_scan_bwd(dh, pre, c, c_prev, sW, reverse=False, iW=None,
                  instance=None):
    """The LSTM gradient chain on given gates (kernel 15); contract of
    `lstm_scan_bwd_plain`.  `instance` as `lstm_bwd_acts`'s."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        return lstm_scan_bwd_plain(dh, pre, c, c_prev, sW, reverse, iW)
    what = "lstm_scan_bwd"
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    specs = [("dh", dh, (T, B, H)), ("pre", pre, (T, B, 4 * H)),
             ("c", c, (T, B, H)), ("c_prev", c_prev, (T, B, H)),
             ("sW", sW, (4 * H, H))]
    D = 0 if iW is None else iW.shape[1]
    if iW is not None:
        specs.append(("iW", iW, (4 * H, D)))
    _check_args(what, dh.device, specs)
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("lstm", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt, = gemm.tma_ready(None if iW is None else iW.t().contiguous())
        dpre = torch.empty(T, B, 4 * H, device=dev)
        d_x = None if iW is None else torch.empty(T, B, D, device=dev)
        db = torch.empty(-(-B // plan.BT), 4 * H, device=dev)
        gplans = ([] if iW is None else
                  gemm.plans_for(dev, (T * B, D, 4 * H, gemm.GATE)))
        err = lib.tt_lstm_scan_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(pre), cuda_lib.ptr(c),
            cuda_lib.ptr(c_prev), cuda_lib.ptr(sW), cuda_lib.ptr(iwt),
            cuda_lib.ptr(dpre), cuda_lib.ptr(d_x), cuda_lib.ptr(db), T, B,
            D, H, int(bool(reverse)), *rnn_plan.c_args(plan),
            gemm.c_args(gplans), cuda_lib.stream(dev))
        rnn_plan.count(lstm_scan_bwd, plan)
        gemm.count(gplans)
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
