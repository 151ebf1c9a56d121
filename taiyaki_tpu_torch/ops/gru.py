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

Streams.  Every kernel has an f32 instance, which takes f32 tensors
alone.  The layer forward and the two layer backwards also have a bf16
instance: the JAX package's mixed precision on its accelerator
(taiyaki_tpu/ops/rnn.py:29-42, :612-700; the port's
TAIYAKI_TPU_BF16_STREAMS=1, ops/rnn.py), with the contract of the LSTM's
(ops/lstm.py).  The forward's `res_dtype=torch.bfloat16` takes it: gh and
gx come back in bf16 (gx the f32 input product rounded once; the f32
scratch is never the residual), h in `h_dtype` (bf16 or f32), from an x of
f32 or bf16; the arithmetic, the carry and the gx scratch stay f32.
`gru_bwd_fusedw` takes it when gx and gh are bf16, `gru_bwd_recompute`
wherever any of dh, h and x is bf16 (it stores no residuals: its rebuilt
gx and gh are f32 scratch); dh, h (h_prev) and x may each be bf16 or f32,
every value is widened at load, dgx and dgh stay f32, d_x comes back in
x's dtype and the weight partials in f32.  The plain twins take the same
dtypes and round exactly where the kernels store.  The recurrences on
given gates have their bf16 instance too, the JAX scans' mixed precision
(taiyaki_tpu/ops/rnn.py:548-588): `gru_scan_fwd(res_dtype=torch.bfloat16)`
reads gates_x of f32 or bf16 (a bf16 gate stream through registers) and
gives h in f32 and gh in bf16; `gru_scan_bwd` on a bf16 gh reads gates_x,
h_prev and dh each in f32 or bf16 and stores dgx and dgh in dh's dtype,
the chain going on from the f32 values.  Each wrapper
counts its bf16 launches (`<wrapper>.bf16`, and
`<wrapper>.bf16_by_instance`).  A bf16 tensor given to an f32 instance,
or a pairing no JAX route produces, raises.

On a CPU tensor the plain PyTorch twin runs; on a CUDA tensor the kernel
launches, or the wrapper raises.  A failed build or launch of a bf16
instance raises; nothing falls back to the f32 instance or the twin.
"""

import functools

import torch

from taiyaki_tpu_torch.ops import cuda_lib, gemm, rnn_plan
from taiyaki_tpu_torch.ops.lstm import (BF16, F32, STREAM_DH, STREAM_H,
                                        STREAM_X, _as, _bwd_streams,
                                        _chain_bf16, _check_args,
                                        _check_hidden, _streams, bwd_outputs,
                                        prev_state)

_P, _I = cuda_lib.P, cuda_lib.I
# (the GEMM plans go as one pointer, an int array: ops/gemm.py `c_args`)
_SIGNATURES = {"tt_gru_fwd": [_P] * 8 + [_I] * 12 + [_P, _P],
               "tt_gru_bwd": [_P] * 13 + [_I] * 6 + [_P] + [_I] * 6 + [_P],
               "tt_gru_bwd_fusedw": [_P] * 13 + [_I] * 6 + [_P] + [_I] * 6
               + [_P],
               "tt_gru_scan_fwd": [_P] * 4 + [_I] * 11 + [_P],
               "tt_gru_cluster_occupancy": [_I] * 6,
               "tt_gru_scan_bwd": [_P] * 10 + [_I] * 12 + [_P, _P]}


def _cell(gx_t, gh_t, h):
    """One GRU step: (r, z, n, h')."""
    r_x, z_x, n_x = gx_t.chunk(3, dim=-1)
    r_h, z_h, n_h = gh_t.chunk(3, dim=-1)
    r = torch.sigmoid(r_x + r_h)
    z = torch.sigmoid(z_x + z_h)
    n = torch.tanh(n_x + r * n_h)
    return r, z, n, (1.0 - z) * n + z * h


def gru_fwd_plain(x, iW, b, sW, reverse=False, emit_residuals=False,
                  h_dtype=None, res_dtype=None):
    """Plain PyTorch GRU forward: x [T, B, D], iW [3H, D], b [3H],
    sW [3H, H] -> h [T, B, H]; with emit_residuals (h, gh, gx), gh and gx
    [T, B, 3H] (the order of the JAX package).  In f32 on x widened, the
    next step on the f32 carry; h comes back in `h_dtype` and gh, gx in
    `res_dtype` (f32 by default)."""
    gx = torch.matmul(x.float(), iW.t()) + b
    out, gh = _gru_rec_plain(gx, sW, reverse, emit_residuals)
    out = _as(out, h_dtype)
    if not emit_residuals:
        return out
    return out, _as(gh, res_dtype), _as(gx, res_dtype)


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
            instance=None, h_dtype=None, res_dtype=None):
    """GRU layer forward; same contract as `gru_fwd_plain`.  `instance`
    ("cluster" or "l2") forces an instance of the recurrence on the card,
    for tests and timing; None takes `rnn_plan.rec_plan`'s.
    `res_dtype=torch.bfloat16` takes the bf16 instance (module notes),
    with or without residuals; else x and h must be f32."""
    rnn_plan.check_instance(instance)
    h_dtype, res_dtype = h_dtype or F32, res_dtype or F32
    streams = _streams("gru_fwd", x.dtype, h_dtype, res_dtype)
    if x.device.type == "cpu":
        return gru_fwd_plain(x, iW, b, sW, reverse, emit_residuals, h_dtype,
                             res_dtype)
    cuda_lib.check_cuda(x, "gru_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("gru_fwd", x.device, (
        ("x", x, (T, B, D), (F32, BF16)), ("iW", iW, (3 * H, D)),
        ("b", b, (3 * H,)), ("sW", sW, (3 * H, H))))
    _check_hidden("gru_fwd", H)
    plan = rnn_plan.rec_plan(3, H, B, clusters_per_wave(
        x.device.index), instance)
    gplans = gemm.plans_for(x.device, (T * B, 3 * H, D, gemm.GATE,
                                       x.dtype == BF16))
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = x.device
    with torch.cuda.device(dev):
        x, iW = gemm.tma_ready(x, iW)
        swt = sW.t().contiguous()
        # gx scratch (f32), kept as the output gx of the f32 instance under
        # emit_residuals; the bf16 instance writes a bf16 copy into gxr
        gx = torch.empty(T, B, 3 * H, device=dev)
        h = torch.empty(T, B, H, device=dev, dtype=h_dtype)
        gh = gxr = None
        if emit_residuals:
            gh = torch.empty(T, B, 3 * H, device=dev, dtype=res_dtype)
            gxr = (torch.empty(T, B, 3 * H, device=dev, dtype=BF16)
                   if res_dtype == BF16 else None)
        err = lib.tt_gru_fwd(
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(swt), cuda_lib.ptr(gx), cuda_lib.ptr(h),
            cuda_lib.ptr(gh), cuda_lib.ptr(gxr), T, B, D, H,
            int(bool(reverse)), streams, *rnn_plan.c_args(plan),
            gemm.c_args(gplans), cuda_lib.stream(dev))
        rnn_plan.count(gru_fwd, plan, bool(streams))
        gemm.count(gplans, [bool(streams & STREAM_X)])
    cuda_lib.check(lib, err, "gru_fwd kernel")
    if not emit_residuals:
        return h
    return h, gh, gx if gxr is None else gxr


def gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse=False):
    """Plain PyTorch GRU backward from the stored gate streams.

    Args:
        dh: [T, B, H] gradient of the layer's output h.
        gx, gh: [T, B, 3H] the forward's gate streams; h_prev: [T, B, H]
            the state entering each step; x: [T, B, D] the layer's input.
        sW: [3H, H]; iW: [3H, D].

    Returns:
        (d_x [T, B, D], d_sW [1, 3H, H], d_iW [1, 3H, D], d_b [1, 3H]):
        the weight gradients as one partial each.  Every input is widened
        to f32; d_x comes back in x's dtype, the rest in f32.
    """
    T, B, H = dh.shape
    h_prev = h_prev.float()
    dgx, dgh = _gru_dgrads_plain(dh.float(), gx.float(), gh.float(), h_prev,
                                 sW, reverse)
    d_x = _as(torch.matmul(dgx, iW), x.dtype)
    fx = dgx.reshape(T * B, 3 * H)
    d_iW = torch.matmul(fx.t(), x.float().reshape(T * B, -1))
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
    iW^T + b and gh = h_prev . sW^T in f32 from h [T, B, H] (the
    forward's hidden states) and b [3H]; the rest as
    `gru_bwd_fusedw_plain`."""
    h_prev = prev_state(h, reverse)
    gx = torch.matmul(x.float(), iW.t()) + b
    gh = torch.matmul(h_prev.float(), sW.t())
    return gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse)


def _bwd_plan(H, B, device, instance, ring16=False):
    """The backward chain's plan on `device` (`rnn_plan.bwd_plan` on the
    card's clusters a wave; `ring16` for a bf16 instance whose ring holds
    bf16 words)."""
    return rnn_plan.bwd_plan(3, H, B, clusters_per_wave(device.index),
                             instance, ring16)


def _recompute_streams(dh, h, x):
    """The `streams` bits of the recomputing backward, which reads no
    residuals: dh, h and x each f32 or bf16, and any of them bf16 takes
    the bf16 instance."""
    what = "gru_bwd_recompute"
    for name, t in (("dh", dh), ("h", h), ("x", x)):
        if t.dtype not in (F32, BF16):
            raise ValueError("{}: {} must be float32 or bfloat16, not "
                             "{}".format(what, name, t.dtype))
    return ((STREAM_X if x.dtype == BF16 else 0)
            | (STREAM_H if h.dtype == BF16 else 0)
            | (STREAM_DH if dh.dtype == BF16 else 0))


def gru_bwd_recompute(dh, h, x, sW, iW, b, reverse=False, instance=None):
    """GRU layer backward; contract of `gru_bwd_recompute_plain`, except
    that the kernel returns d_sW and d_iW as [nsplit, ...] partials over
    slices of the T*B rows and d_b as [ceil(B / BT), 3H] partials over the
    chain plan's batch tiles; the caller sums them.  `instance`
    ("cluster" or "l2") forces an instance of the chain on the card, for
    tests and timing; None takes `rnn_plan.bwd_plan`'s."""
    rnn_plan.check_instance(instance)
    streams = _recompute_streams(dh, h, x)
    if dh.device.type == "cpu":
        return gru_bwd_recompute_plain(dh, h, x, sW, iW, b, reverse)
    what = "gru_bwd_recompute"
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    both = (F32, BF16)
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H), both), ("h", h, (T, B, H), both),
        ("x", x, (T, B, D), both), ("sW", sW, (3 * H, H)),
        ("iW", iW, (3 * H, D)), ("b", b, (3 * H,))))
    _check_hidden(what, H)
    # the bf16 instance's ring holds bf16 words where h or dh is bf16 (its
    # gx and gh are the rebuilt f32 streams)
    plan = _bwd_plan(H, B, dh.device, instance,
                     bool(streams & (STREAM_H | STREAM_DH)))
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, iW, h, sW, iwt = gemm.tma_ready(x, iW, h, sW,
                                           iW.t().contiguous())
        dh, h = rnn_plan.ring_ready(plan, H, bool(streams), dh, h)
        # gx and gh (f32), overwritten in place by dgx and dgh
        g_x = torch.empty(T, B, 3 * H, device=dev)
        g_h = torch.empty(T, B, 3 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 3 * H, H, dev, plan, x.dtype,
                                  h.dtype)
        # gx = x iW^T + b and gh = h_prev sW^T on all but the boundary step
        gplans = gemm.plans_for(
            dev, (T * B, 3 * H, D, gemm.GATE, x.dtype == BF16),
            ((T - 1) * B, 3 * H, H, gemm.GATE, h.dtype == BF16)) + gplans
        err = lib.tt_gru_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(iW), cuda_lib.ptr(b), cuda_lib.ptr(sW),
            cuda_lib.ptr(iwt), cuda_lib.ptr(g_x), cuda_lib.ptr(g_h),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            streams, gemm.c_args(gplans), *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_bwd_recompute, plan, bool(streams))
        bf = ([bool(streams & STREAM_X), bool(streams & STREAM_H)]
              + _chain_bf16(streams))
        if T > 1:
            gemm.count(gplans, bf)
        else:
            gemm.count(gplans[:1] + gplans[2:], bf[:1] + bf[2:])
    cuda_lib.check(lib, err, what + " kernel")
    return out


def gru_bwd_fusedw(dh, gx, gh, h_prev, x, sW, iW, reverse=False,
                   instance=None):
    """GRU layer backward from the stored gate streams; contract of
    `gru_bwd_fusedw_plain`, with the partials and `instance` of
    `gru_bwd_recompute`.  gx and gh are read, never written: the gradients
    go to scratch of their own.  bf16 gx and gh take the bf16 instance;
    bf16 dh, h_prev or x need it."""
    rnn_plan.check_instance(instance)
    what = "gru_bwd_fusedw"
    streams = _bwd_streams(what, (gx, gh), dh, h_prev, x)
    if dh.device.type == "cpu":
        return gru_bwd_fusedw_plain(dh, gx, gh, h_prev, x, sW, iW, reverse)
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    D = x.shape[2]
    both = (F32, BF16)
    _check_args(what, dh.device, (
        ("dh", dh, (T, B, H), both), ("gx", gx, (T, B, 3 * H), both),
        ("gh", gh, (T, B, 3 * H), both),
        ("h_prev", h_prev, (T, B, H), both), ("x", x, (T, B, D), both),
        ("sW", sW, (3 * H, H)), ("iW", iW, (3 * H, D))))
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance, bool(streams))
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        x, h_prev, iwt = gemm.tma_ready(x, h_prev, iW.t().contiguous())
        dh, gx, gh, h_prev = rnn_plan.ring_ready(plan, H, bool(streams), dh,
                                                 gx, gh, h_prev)
        dgx = torch.empty(T, B, 3 * H, device=dev)
        dgh = torch.empty(T, B, 3 * H, device=dev)
        out, gplans = bwd_outputs(T, B, D, 3 * H, H, dev, plan, x.dtype,
                                  h_prev.dtype)
        err = lib.tt_gru_bwd_fusedw(
            cuda_lib.ptr(dh), cuda_lib.ptr(gx), cuda_lib.ptr(gh),
            cuda_lib.ptr(h_prev), cuda_lib.ptr(x), cuda_lib.ptr(sW),
            cuda_lib.ptr(iwt), cuda_lib.ptr(dgx), cuda_lib.ptr(dgh),
            *map(cuda_lib.ptr, out), T, B, D, H, int(bool(reverse)),
            streams, gemm.c_args(gplans), *rnn_plan.c_args(plan),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_bwd_fusedw, plan, bool(streams))
        gemm.count(gplans, _chain_bf16(streams))
    cuda_lib.check(lib, err, what + " kernel")
    return out


def gru_scan_fwd_plain(gates_x, sW, reverse=False, residuals=False,
                       res_dtype=None):
    """Plain PyTorch GRU recurrence on given input gates gates_x [T, B, 3H]
    (= x . iW^T + b, gate order r, z, n; f32 or bf16, widened), sW [3H, H]
    -> h [T, B, H] (f32); with residuals (h, gh [T, B, 3H]), gh rounded to
    `res_dtype` (f32 by default) where the kernel stores it."""
    out, gh = _gru_rec_plain(gates_x.float(), sW, reverse, residuals)
    return (out, _as(gh, res_dtype)) if residuals else out


def gru_scan_fwd(gates_x, sW, reverse=False, residuals=False,
                 instance=None, res_dtype=None):
    """The GRU recurrence on given gates (kernel 16); contract of
    `gru_scan_fwd_plain`.  gates_x is read, never written, nor copied (the
    caller keeps it for the backward).  `res_dtype=torch.bfloat16` takes
    the bf16 instance, on gates_x of f32 or bf16 (the JAX scans' mixed
    precision: h f32, gh bf16); else gates_x must be f32.  `instance` as
    `gru_fwd`'s."""
    rnn_plan.check_instance(instance)
    what = "gru_scan_fwd"
    res_dtype = res_dtype or F32
    streams = _streams(what, gates_x.dtype, F32, res_dtype)
    if gates_x.device.type == "cpu":
        return gru_scan_fwd_plain(gates_x, sW, reverse, residuals, res_dtype)
    cuda_lib.check_cuda(gates_x, what)
    T, B = gates_x.shape[:2]
    H = sW.shape[1]
    _check_args(what, gates_x.device, (
        ("gates_x", gates_x, (T, B, 3 * H), (F32, BF16)),
        ("sW", sW, (3 * H, H))))
    _check_hidden(what, H)
    plan = rnn_plan.rec_plan(3, H, B, clusters_per_wave(
        gates_x.device.index), instance)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = gates_x.device
    with torch.cuda.device(dev):
        swt = sW.t().contiguous()
        h = torch.empty(T, B, H, device=dev)
        gh = (torch.empty(T, B, 3 * H, device=dev, dtype=res_dtype)
              if residuals else None)
        err = lib.tt_gru_scan_fwd(
            cuda_lib.ptr(gates_x), cuda_lib.ptr(swt), cuda_lib.ptr(h),
            cuda_lib.ptr(gh), T, B, H, int(bool(reverse)), streams,
            *rnn_plan.c_args(plan), cuda_lib.stream(dev))
        rnn_plan.count(gru_scan_fwd, plan, bool(streams))
    cuda_lib.check(lib, err, what + " kernel")
    return (h, gh) if residuals else h


def gru_scan_bwd_plain(dh, gates_x, gh, h_prev, sW, reverse=False, iW=None):
    """Plain PyTorch GRU gradient chain on the recurrence's residuals: dh,
    h_prev [T, B, H], gates_x, gh [T, B, 3H], sW [3H, H] -> (dgx, dgh)
    [T, B, 3H] (dgx = d gates_x), each input widened, dgx and dgh rounded
    to dh's dtype where the kernel stores them, the chain going on from
    the f32 values; with iW [3H, D] (dgx, dgh, d_x = dgx . iW [T, B, D],
    f32, from the stored dgx).  `reverse` is the
    forward's direction; the chain walks opposite."""
    dgx, dgh = (_as(g, dh.dtype) for g in _gru_dgrads_plain(
        dh.float(), gates_x.float(), gh.float(), h_prev.float(), sW,
        reverse))
    if iW is None:
        return dgx, dgh
    return dgx, dgh, torch.matmul(dgx.float(), iW)


def gru_scan_bwd(dh, gates_x, gh, h_prev, sW, reverse=False, iW=None,
                 instance=None):
    """The GRU gradient chain on given gates (kernel 17); contract of
    `gru_scan_bwd_plain`.  gates_x and gh are read, never written.  A bf16
    gh takes the bf16 instance, with gates_x, h_prev and dh (and so the
    stored gradients) each bf16 or f32 (the JAX scans give f32 gates_x
    under TAIYAKI_TPU_F32_GATES); an f32 gh the
    f32 instance, all f32.  `instance` as `gru_bwd_recompute`'s."""
    rnn_plan.check_instance(instance)
    what = "gru_scan_bwd"
    streams = _bwd_streams(what, (gh,), dh, h_prev, gates_x)
    if dh.device.type == "cpu":
        return gru_scan_bwd_plain(dh, gates_x, gh, h_prev, sW, reverse, iW)
    cuda_lib.check_cuda(dh, what)
    T, B, H = dh.shape
    both = (F32, BF16)
    specs = [("dh", dh, (T, B, H), both),
             ("gates_x", gates_x, (T, B, 3 * H), both),
             ("gh", gh, (T, B, 3 * H), both),
             ("h_prev", h_prev, (T, B, H), both), ("sW", sW, (3 * H, H))]
    D = 0 if iW is None else iW.shape[1]
    if iW is not None:
        specs.append(("iW", iW, (3 * H, D)))
    _check_args(what, dh.device, specs)
    _check_hidden(what, H)
    plan = _bwd_plan(H, B, dh.device, instance, bool(streams))
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt, = gemm.tma_ready(None if iW is None else iW.t().contiguous())
        dh, gates_x, gh, h_prev = rnn_plan.ring_ready(
            plan, H, bool(streams), dh, gates_x, gh, h_prev)
        dgx = torch.empty(T, B, 3 * H, device=dev, dtype=dh.dtype)
        dgh = torch.empty(T, B, 3 * H, device=dev, dtype=dh.dtype)
        d_x = None if iW is None else torch.empty(T, B, D, device=dev)
        db = torch.empty(-(-B // plan.BT), 3 * H, device=dev)
        gplans = ([] if iW is None else gemm.plans_for(
            dev, (T * B, D, 3 * H, gemm.GATE, dh.dtype == BF16)))
        err = lib.tt_gru_scan_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(gates_x), cuda_lib.ptr(gh),
            cuda_lib.ptr(h_prev), cuda_lib.ptr(sW), cuda_lib.ptr(iwt),
            cuda_lib.ptr(dgx), cuda_lib.ptr(dgh), cuda_lib.ptr(d_x),
            cuda_lib.ptr(db), T, B, D, H, int(bool(reverse)), streams,
            *rnn_plan.c_args(plan), gemm.c_args(gplans),
            cuda_lib.stream(dev))
        rnn_plan.count(gru_scan_bwd, plan, bool(streams))
        gemm.count(gplans, [dh.dtype == BF16])
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
for _fn in (gru_fwd, gru_scan_fwd, gru_scan_bwd, gru_bwd_recompute,
            gru_bwd_fusedw):
    _fn.bf16 = rnn_plan.Launches()
    _fn.bf16_by_instance = rnn_plan.instance_counters()
