"""GRU layer forward and recomputing backward: the CUDA kernels
(csrc/gru.cu) and their plain twins.

`gru_fwd` computes what the TPU kernel taiyaki_tpu/ops/pallas_rnn.py:995
`gru_fused_fwd` computes with emit_residuals=False: the hidden states of
one GRU layer, the input product x . iW^T + b included, in f32.
`gru_bwd_recompute` computes what pallas_rnn.py:1311 `gru_bwd_recompute`
computes: from dh, h and x alone (the gate streams are rebuilt) d_x and
the weight gradients as partial sums, which the caller adds up.  Gate
order is CUDNN's (r, z, n); the cell has no hidden bias:
    r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z),
    n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h.
The port takes any T as it is (no time padding); `reverse` walks time
backwards and keeps the outputs in natural order.

On a CPU tensor the plain PyTorch twin runs; on a CUDA tensor the kernel
launches, or the wrapper raises.
"""

import torch

from taiyaki_tpu_torch.ops import cuda_lib
from taiyaki_tpu_torch.ops.lstm import (BATCH_TILE, _check_args,
                                        _check_hidden, _nsplit, prev_state)

_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_gru_fwd": [_P] * 6 + [_I] * 5 + [_P],
               "tt_gru_bwd": [_P] * 13 + [_I] * 6 + [_P]}


def _cell(gx_t, gh_t, h):
    """One GRU step: (r, z, n, h')."""
    r_x, z_x, n_x = gx_t.chunk(3, dim=-1)
    r_h, z_h, n_h = gh_t.chunk(3, dim=-1)
    r = torch.sigmoid(r_x + r_h)
    z = torch.sigmoid(z_x + z_h)
    n = torch.tanh(n_x + r * n_h)
    return r, z, n, (1.0 - z) * n + z * h


def gru_fwd_plain(x, iW, b, sW, reverse=False):
    """Plain PyTorch GRU forward: x [T, B, D], iW [3H, D], b [3H],
    sW [3H, H] -> h [T, B, H]."""
    T, B, _ = x.shape
    H = sW.shape[1]
    gx = torch.matmul(x, iW.t()) + b
    h = x.new_zeros(B, H)
    out = x.new_empty(T, B, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = _cell(gx[t], torch.matmul(h, sW.t()), h)[3]
        out[t] = h
    return out


def gru_fwd(x, iW, b, sW, reverse=False):
    """GRU layer forward; same contract as `gru_fwd_plain`."""
    if x.device.type == "cpu":
        return gru_fwd_plain(x, iW, b, sW, reverse)
    cuda_lib.check_cuda(x, "gru_fwd")
    T, B, D = x.shape
    H = sW.shape[1]
    _check_args("gru_fwd", x.device, (
        ("x", x, (T, B, D)), ("iW", iW, (3 * H, D)), ("b", b, (3 * H,)),
        ("sW", sW, (3 * H, H))))
    _check_hidden("gru_fwd", H)
    lib = cuda_lib.load("gru", _SIGNATURES)
    with torch.cuda.device(x.device):
        swt = sW.t().contiguous()
        gx = torch.empty(T, B, 3 * H, device=x.device)
        h = torch.empty(T, B, H, device=x.device)
        err = lib.tt_gru_fwd(
            cuda_lib.ptr(x), cuda_lib.ptr(iW), cuda_lib.ptr(b),
            cuda_lib.ptr(swt), cuda_lib.ptr(gx), cuda_lib.ptr(h),
            T, B, D, H, int(bool(reverse)), cuda_lib.stream(x.device))
        gru_fwd.launches += 1
    cuda_lib.check(lib, err, "gru_fwd kernel")
    return h


def gru_bwd_recompute_plain(dh, h, x, sW, iW, b, reverse=False):
    """Plain PyTorch GRU backward, rebuilding the gate streams.

    Args:
        dh: [T, B, H] gradient of the layer's output h.
        h: [T, B, H] hidden states of the forward; x: [T, B, D] its input.
        sW: [3H, H]; iW: [3H, D]; b: [3H].

    Returns:
        (d_x [T, B, D], d_sW [1, 3H, H], d_iW [1, 3H, D], d_b [1, 3H]):
        the weight gradients as one partial each.
    """
    T, B, H = dh.shape
    h_prev = prev_state(h, reverse)
    gx = torch.matmul(x, iW.t()) + b
    gh = torch.matmul(h_prev, sW.t())
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
    d_x = torch.matmul(dgx, iW)
    fx = dgx.reshape(T * B, 3 * H)
    d_iW = torch.matmul(fx.t(), x.reshape(T * B, -1))
    d_sW = torch.matmul(dgh.reshape(T * B, 3 * H).t(),
                        h_prev.reshape(T * B, H))
    return d_x, d_sW[None], d_iW[None], fx.sum(0)[None]


def gru_bwd_recompute(dh, h, x, sW, iW, b, reverse=False):
    """GRU layer backward; contract of `gru_bwd_recompute_plain`, except
    that the kernel returns d_sW and d_iW as [nsplit, ...] partials over
    slices of the T*B rows and d_b as [ceil(B/8), 3H] partials over batch
    tiles; the caller sums them."""
    if dh.device.type == "cpu":
        return gru_bwd_recompute_plain(dh, h, x, sW, iW, b, reverse)
    cuda_lib.check_cuda(dh, "gru_bwd_recompute")
    T, B, H = dh.shape
    D = x.shape[2]
    _check_args("gru_bwd_recompute", dh.device, (
        ("dh", dh, (T, B, H)), ("h", h, (T, B, H)), ("x", x, (T, B, D)),
        ("sW", sW, (3 * H, H)), ("iW", iW, (3 * H, D)), ("b", b, (3 * H,))))
    _check_hidden("gru_bwd_recompute", H)
    nsplit = _nsplit(T * B)
    ntile = -(-B // BATCH_TILE)
    lib = cuda_lib.load("gru", _SIGNATURES)
    dev = dh.device
    with torch.cuda.device(dev):
        iwt = iW.t().contiguous()
        # gx and gh, overwritten in place by dgx and dgh
        g_x = torch.empty(T, B, 3 * H, device=dev)
        g_h = torch.empty(T, B, 3 * H, device=dev)
        d_x = torch.empty(T, B, D, device=dev)
        d_sW = torch.empty(nsplit, 3 * H, H, device=dev)
        d_iW = torch.empty(nsplit, 3 * H, D, device=dev)
        d_b = torch.empty(ntile, 3 * H, device=dev)
        err = lib.tt_gru_bwd(
            cuda_lib.ptr(dh), cuda_lib.ptr(h), cuda_lib.ptr(x),
            cuda_lib.ptr(iW), cuda_lib.ptr(b), cuda_lib.ptr(sW),
            cuda_lib.ptr(iwt), cuda_lib.ptr(g_x), cuda_lib.ptr(g_h),
            cuda_lib.ptr(d_x), cuda_lib.ptr(d_sW), cuda_lib.ptr(d_iW),
            cuda_lib.ptr(d_b), T, B, D, H, int(bool(reverse)), nsplit,
            cuda_lib.stream(dev))
        gru_bwd_recompute.launches += 1
    cuda_lib.check(lib, err, "gru_bwd_recompute kernel")
    return d_x, d_sW, d_iW, d_b


gru_fwd.launches = 0
gru_bwd_recompute.launches = 0
