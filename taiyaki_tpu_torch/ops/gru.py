"""GRU layer forward and backwards: the CUDA kernels (csrc/gru.cu) and
their plain twins.

`gru_fwd` computes what the TPU kernel taiyaki_tpu/ops/pallas_rnn.py:995
`gru_fused_fwd` computes: the hidden states of one GRU layer, the input
product x . iW^T + b included, in f32, and with emit_residuals=True the
gate streams gh = h_prev . sW^T and gx = x . iW^T + b beside them.
`gru_bwd_recompute` computes what pallas_rnn.py:1311 `gru_bwd_recompute`
computes: from dh, h and x alone (the gate streams are rebuilt) d_x and
the weight gradients as partial sums, which the caller adds up;
`gru_bwd_fusedw` the same from the stored gate streams, as
pallas_rnn.py:1184 `gru_bwd_fusedw`.  Gate
order is CUDNN's (r, z, n); the cell has no hidden bias:
    r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z),
    n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h.
The port takes any T as it is (no time padding); `reverse` walks time
backwards and keeps the outputs in natural order.

`gru_scan_fwd` and `gru_scan_bwd` are the recurrence on given input gates
without the input product, what pallas_rnn.py:1082 `gru_fwd` and :1407
`gru_bwd` compute: h (and the residual gh) from gates_x [T, B, 3H], and
the gradients dgx (= d gates_x) and dgh, with iW also d_x.  They run the
layer kernels' chains (csrc/gru.cu).

The forward recurrence (of `gru_fwd` and `gru_scan_fwd`) and the
backward chain (of the two backwards and `gru_scan_bwd`) each have a
cluster and an L2 instance that compute the same values, picked by
`rnn_plan.rec_plan` and `rnn_plan.bwd_plan` and counted per instance as
the LSTM's (ops/lstm.py); `instance=` forces one, for tests and timing.

On a CPU tensor the plain PyTorch twin runs; on a CUDA tensor the kernel
launches, or the wrapper raises.
"""

import functools

import torch

from taiyaki_tpu_torch.ops import cuda_lib, gemm, rnn_plan
from taiyaki_tpu_torch.ops.lstm import (_check_args, _check_hidden,
                                        bwd_outputs, prev_state)

_P, _I = cuda_lib.P, cuda_lib.I
# (the GEMM plans go as one pointer, an int array: ops/gemm.py `c_args`)
_SIGNATURES = {"tt_gru_fwd": [_P] * 7 + [_I] * 11 + [_P, _P],
               "tt_gru_bwd": [_P] * 13 + [_I] * 5 + [_P] + [_I] * 6 + [_P],
               "tt_gru_bwd_fusedw": [_P] * 13 + [_I] * 5 + [_P] + [_I] * 6
               + [_P],
               "tt_gru_scan_fwd": [_P] * 4 + [_I] * 10 + [_P],
               "tt_gru_cluster_occupancy": [_I] * 6,
               "tt_gru_scan_bwd": [_P] * 10 + [_I] * 11 + [_P, _P]}


def _cell(gx_t, gh_t, h):
    """One GRU step: (r, z, n, h')."""
    r_x, z_x, n_x = gx_t.chunk(3, dim=-1)
    r_h, z_h, n_h = gh_t.chunk(3, dim=-1)
    r = torch.sigmoid(r_x + r_h)
    z = torch.sigmoid(z_x + z_h)
    n = torch.tanh(n_x + r * n_h)
    return r, z, n, (1.0 - z) * n + z * h


def gru_fwd_plain(x, iW, b, sW, reverse=False, emit_residuals=False):
    """Plain PyTorch GRU forward: x [T, B, D], iW [3H, D], b [3H],
    sW [3H, H] -> h [T, B, H]; with emit_residuals (h, gh, gx), gh and gx
    [T, B, 3H] (the order of the JAX package)."""
    gx = torch.matmul(x, iW.t()) + b
    out, gh = _gru_rec_plain(gx, sW, reverse, emit_residuals)
    return (out, gh, gx) if emit_residuals else out


def _gru_rec_plain(gx, sW, reverse, residuals):
    """The recurrence on the input gates gx [T, B, 3H]: (h, gh), gh None
    unless residuals."""
    T, B, _ = gx.shape
    H = sW.shape[1]
    h = gx.new_zeros(B, H)
    out = gx.new_empty(T, B, H)
    gh = gx.new_empty(T, B, 3 * H) if residuals else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh_t = torch.matmul(h, sW.t())
        h = _cell(gx[t], gh_t, h)[3]
        out[t] = h
        if residuals:
            gh[t] = gh_t
    return out, gh


def gru_fwd(x, iW, b, sW, reverse=False, emit_residuals=False,
            instance=None):
    """GRU layer forward; same contract as `gru_fwd_plain`.  `instance`
    ("cluster" or "l2") forces an instance of the recurrence on the card,
    for tests and timing; None takes `rnn_plan.rec_plan`'s."""
    rnn_plan.check_instance(instance)
    if x.device.type == "cpu":
        return gru_fwd_plain(x, iW, b, sW, reverse, emit_residuals)
    cuda_lib.check_cuda(x, "gru_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("gru_fwd", x.device, (
        ("x", x, (T, B, D)), ("iW", iW, (3 * H, D)), ("b", b, (3 * H,)),
        ("sW", sW, (3 * H, H))))
    _check_hidden("gru_fwd", H)
    plan = rnn_plan.rec_plan(3, H, B, clusters_per_wave(
        x.device.index), instance)
    gplans = gemm.plans_for(x.device, (T * B, 3 * H, D, gemm.GATE))
    lib = cuda_lib.load("gru", _SIGNATURES)
    with torch.cuda.device(x.device):
        x, iW = gemm.tma_ready(x, iW)
        swt = sW.t().contiguous()
        # gx scratch, kept as the output gx under emit_residuals
        gx = torch.empty(T, B, 3 * H, device=x.device)
        h = torch.empty(T, B, H, device=x.device)
        gh = (torch.empty(T, B, 3 * H, device=x.device) if emit_residuals
              else None)
        err = lib.tt_gru_fwd(
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(swt), cuda_lib.ptr(gx), cuda_lib.ptr(h),
            cuda_lib.ptr(gh), T, B, D, H, int(bool(reverse)),
            *rnn_plan.c_args(plan), gemm.c_args(gplans),
            cuda_lib.stream(x.device))
        rnn_plan.count(gru_fwd, plan)
        gemm.count(gplans)
    cuda_lib.check(lib, err, "gru_fwd kernel")
    return (h, gh, gx) if emit_residuals else h


def gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse=False):
    """Plain PyTorch GRU backward from the stored gate streams.

    Args:
        dh: [T, B, H] gradient of the layer's output h.
        gx, gh: [T, B, 3H] the forward's gate streams; h_prev: [T, B, H]
            the state entering each step; x: [T, B, D] the layer's input.
        sW: [3H, H]; iW: [3H, D].

    Returns:
        (d_x [T, B, D], d_sW [1, 3H, H], d_iW [1, 3H, D], d_b [1, 3H]):
        the weight gradients as one partial each.
    """
    T, B, H = dh.shape
    dgx, dgh = _gru_dgrads_plain(dh, gx, gh, h_prev, sW, reverse)
    d_x = torch.matmul(dgx, iW)
    fx = dgx.reshape(T * B, 3 * H)
    d_iW = torch.matmul(fx.t(), x.reshape(T * B, -1))
    d_sW = torch.matmul(dgh.reshape(T * B, 3 * H).t(),
                        h_prev.reshape(T * B, H))
    return d_x, d_sW[None], d_iW[None], fx.sum(0)[None]


def _gru_dgrads_plain(dh, gx, gh, h_prev, sW, reverse):
    """The gradient chain: (dgx, dgh) [T, B, 3H] from dh, the gate streams
    and h_prev, walking opposite to the forward direction."""
    T, B, H = dh.shape
    dgx = dh.new_empty(T, B, 3 * H)
    dgh = dh.new_empty(T, B, 3 * H)
    dh_c = dh.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        r, z, n, _ = _cell(gx[t], gh[t], h_prev[t])
        d = dh[t] + dh_c
        dn_pre = d * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * gh[t, :, 2 * H:] * r * (1.0 - r)
        dz_pre = d * (h_prev[t] - n) * z * (1.0 - z)
        dgx[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dgh[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
        dh_c = torch.matmul(dgh[t], sW) + d * z
    return dgx, dgh


def gru_bwd_recompute_plain(dh, h, x, sW, iW, b, reverse=False):
    """Plain PyTorch GRU backward, rebuilding the gate streams gx = x .
    iW^T + b and gh = h_prev . sW^T from h [T, B, H] (the forward's
    hidden states) and b [3H]; the rest as `gru_bwd_fusedw_plain`."""
    h_prev = prev_state(h, reverse)
    gx = torch.matmul(x, iW.t()) + b
    gh = torch.matmul(h_prev, sW.t())
    return gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse)


def _bwd_plan(H, B, device, instance):
    """The backward chain's plan on `device` (`rnn_plan.bwd_plan` on the
    card's clusters a wave)."""
    return rnn_plan.bwd_plan(3, H, B, clusters_per_wave(device.index),
                             instance)


def gru_bwd_recompute(dh, h, x, sW, iW, b, reverse=False, instance=None):
    """GRU layer backward; contract of `gru_bwd_recompute_plain`, except
    that the kernel returns d_sW and d_iW as [nsplit, ...] partials over
    slices of the T*B rows and d_b as [ceil(B / BT), 3H] partials over the
    chain plan's batch tiles; the caller sums them.  `instance`
    ("cluster" or "l2") forces an instance of the chain on the card, for
    tests and timing; None takes `rnn_plan.bwd_plan`'s."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        return gru_bwd_recompute_plain(dh, h, x, sW, iW, b, reverse)
    cuda_lib.check_cuda(dh, "gru_bwd_recompute")
    T, B, H = dh.shape
    D = x.shape[2]
    _check_args("gru_bwd_recompute", dh.device, (
        ("dh", dh, (T, B, H)), ("h", h, (T, B, H)), ("x", x, (T, B, D)),
        ("sW", sW, (3 * H, H)), ("iW", iW, (3 * H, D)), ("b", b, (3 * H,))))
    _check_hidden("gru_bwd_recompute", H)
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, iW, h, sW, iwt = gemm.tma_ready(x, iW, h, sW,
                                           iW.t().contiguous())
        # gx and gh, overwritten in place by dgx and dgh
        g_x = torch.empty(T, B, 3 * H, device=dev)
        g_h = torch.empty(T, B, 3 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 3 * H, H, dev, plan)
        # gx = x iW^T + b and gh = h_prev sW^T on all but the boundary step
        gplans = gemm.plans_for(dev, (T * B, 3 * H, D, gemm.GATE),
                                ((T - 1) * B, 3 * H, H, gemm.GATE)) + gplans
        err = lib.tt_gru_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(iW), cuda_lib.ptr(b), cuda_lib.ptr(sW),
            cuda_lib.ptr(iwt), cuda_lib.ptr(g_x), cuda_lib.ptr(g_h),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            gemm.c_args(gplans), *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_bwd_recompute, plan)
        gemm.count(gplans if T > 1 else gplans[:1] + gplans[2:])
    cuda_lib.check(lib, err, "gru_bwd_recompute kernel")
    return out


def gru_bwd_fusedw(dh, gx, gh, h_prev, x, sW, iW, reverse=False,
                   instance=None):
    """GRU layer backward from the stored gate streams; contract of
    `gru_bwd_fusedw_plain`, with the partials and `instance` of
    `gru_bwd_recompute`.  gx and gh are read, never written: the gradients
    go to scratch of their own."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        return gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse)
    cuda_lib.check_cuda(dh, "gru_bwd_fusedw")
    T, B, H = dh.shape
    D = x.shape[2]
    _check_args("gru_bwd_fusedw", dh.device, (
        ("dh", dh, (T, B, H)), ("gx", gx, (T, B, 3 * H)),
        ("gh", gh, (T, B, 3 * H)), ("h_prev", h_prev, (T, B, H)),
        ("x", x, (T, B, D)), ("sW", sW, (3 * H, H)),
        ("iW", iW, (3 * H, D))))
    _check_hidden("gru_bwd_fusedw", H)
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, h_prev, iwt = gemm.tma_ready(x, h_prev, iW.t().contiguous())
        dgx = torch.empty(T, B, 3 * H, device=dev)
        dgh = torch.empty(T, B, 3 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 3 * H, H, dev, plan)
        err = lib.tt_gru_bwd_fusedw(
            cuda_lib.ptr(dh), cuda_lib.ptr(gx), cuda_lib.ptr(gh),
            cuda_lib.ptr(h_prev), cuda_lib.ptr(x), cuda_lib.ptr(sW),
            cuda_lib.ptr(iwt), cuda_lib.ptr(dgx), cuda_lib.ptr(dgh),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            gemm.c_args(gplans), *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_bwd_fusedw, plan)
        gemm.count(gplans)
    cuda_lib.check(lib, err, "gru_bwd_fusedw kernel")
    return out


def gru_scan_fwd_plain(gates_x, sW, reverse=False, residuals=False):
    """Plain PyTorch GRU recurrence on given input gates gates_x [T, B, 3H]
    (= x . iW^T + b, gate order r, z, n), sW [3H, H] -> h [T, B, H]; with
    residuals (h, gh [T, B, 3H])."""
    out, gh = _gru_rec_plain(gates_x, sW, reverse, residuals)
    return (out, gh) if residuals else out


def gru_scan_fwd(gates_x, sW, reverse=False, residuals=False,
                 instance=None):
    """The GRU recurrence on given gates (kernel 16); contract of
    `gru_scan_fwd_plain`.  gates_x is read, never written.  `instance` as
    `gru_fwd`'s."""
    rnn_plan.check_instance(instance)
    if gates_x.device.type == "cpu":
        return gru_scan_fwd_plain(gates_x, sW, reverse, residuals)
    what = "gru_scan_fwd"
    cuda_lib.check_cuda(gates_x, what)
    T, B = gates_x.shape[:2]
    H = sW.shape[1]
    _check_args(what, gates_x.device, (
        ("gates_x", gates_x, (T, B, 3 * H)), ("sW", sW, (3 * H, H))))
    _check_hidden(what, H)
    plan = rnn_plan.rec_plan(3, H, B, clusters_per_wave(
        gates_x.device.index), instance)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = gates_x.device
    with torch.cuda.device(dev):
        swt = sW.t().contiguous()
        h = torch.empty(T, B, H, device=dev)
        gh = torch.empty(T, B, 3 * H, device=dev) if residuals else None
        err = lib.tt_gru_scan_fwd(
            cuda_lib.ptr(gates_x), cuda_lib.ptr(swt), cuda_lib.ptr(h),
            cuda_lib.ptr(gh), T, B, H, int(bool(reverse)),
            *rnn_plan.c_args(plan), cuda_lib.stream(dev))
        rnn_plan.count(gru_scan_fwd, plan)
    cuda_lib.check(lib, err, what + " kernel")
    return (h, gh) if residuals else h


def gru_scan_bwd_plain(dh, gates_x, gh, h_prev, sW, reverse=False, iW=None):
    """Plain PyTorch GRU gradient chain on the recurrence's residuals: dh,
    h_prev [T, B, H], gates_x, gh [T, B, 3H], sW [3H, H] -> (dgx, dgh)
    [T, B, 3H] (dgx = d gates_x); with iW [3H, D] (dgx, dgh, d_x = dgx .
    iW [T, B, D]).  `reverse` is the forward's direction; the chain walks
    opposite."""
    dgx, dgh = _gru_dgrads_plain(dh, gates_x, gh, h_prev, sW, reverse)
    if iW is None:
        return dgx, dgh
    return dgx, dgh, torch.matmul(dgx, iW)


def gru_scan_bwd(dh, gates_x, gh, h_prev, sW, reverse=False, iW=None,
                 instance=None):
    """The GRU gradient chain on given gates (kernel 17); contract of
    `gru_scan_bwd_plain`.  gates_x and gh are read, never written.
    `instance` as `gru_bwd_recompute`'s."""
    rnn_plan.check_instance(instance)
    if dh.device.type == "cpu":
        return gru_scan_bwd_plain(dh, gates_x, gh, h_prev, sW, reverse, iW)
    what = "gru_scan_bwd"
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    specs = [("dh", dh, (T, B, H)), ("gates_x", gates_x, (T, B, 3 * H)),
             ("gh", gh, (T, B, 3 * H)), ("h_prev", h_prev, (T, B, H)),
             ("sW", sW, (3 * H, H))]
    D = 0 if iW is None else iW.shape[1]
    if iW is not None:
        specs.append(("iW", iW, (3 * H, D)))
    _check_args(what, dh.device, specs)
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt, = gemm.tma_ready(None if iW is None else iW.t().contiguous())
        dgx = torch.empty(T, B, 3 * H, device=dev)
        dgh = torch.empty(T, B, 3 * H, device=dev)
        d_x = None if iW is None else torch.empty(T, B, D, device=dev)
        db = torch.empty(-(-B // plan.BT), 3 * H, device=dev)
        gplans = ([] if iW is None else
                  gemm.plans_for(dev, (T * B, D, 3 * H, gemm.GATE)))
        err = lib.tt_gru_scan_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(gates_x), cuda_lib.ptr(gh),
            cuda_lib.ptr(h_prev), cuda_lib.ptr(sW), cuda_lib.ptr(iwt),
            cuda_lib.ptr(dgx), cuda_lib.ptr(dgh), cuda_lib.ptr(d_x),
            cuda_lib.ptr(db), T, B, D, H, int(bool(reverse)),
            *rnn_plan.c_args(plan), gemm.c_args(gplans),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_scan_bwd, plan)
        gemm.count(gplans)
    cuda_lib.check(lib, err, what + " kernel")
    return (dgx, dgh) if iW is None else (dgx, dgh, d_x)


def cluster_occupancy(H, plan):
    """How many clusters of the cluster instance's `plan` for H units the
    card runs at once (cudaOccupancyMaxActiveClusters), on the current
    CUDA device."""
    lib = cuda_lib.load("gru", _SIGNATURES)
    n = lib.tt_gru_cluster_occupancy(H, plan.C, plan.BT, plan.RB,
                                      plan.KS, plan.smem)
    cuda_lib.check(lib, -min(n, 0), "tt_gru_cluster_occupancy")
    return n


@functools.lru_cache(maxsize=None)
def clusters_per_wave(index):
    """How many clusters of each of rnn_plan.CLUSTER_SIZES CUDA device
    `index` runs at once (`rnn_plan.clusters_per_wave`), read from the
    card once: the plans fill that card, whatever its SMs and GPCs."""
    with torch.cuda.device(index):
        return rnn_plan.clusters_per_wave(cluster_occupancy)


for _fn in (gru_fwd, gru_scan_fwd, gru_scan_bwd, gru_bwd_recompute,
            gru_bwd_fusedw):
    _fn.launches = 0
    _fn.by_instance = rnn_plan.instance_counters()
