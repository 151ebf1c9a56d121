"""Flip-flop CRF lattice forward and backward: the CUDA kernels
(csrc/crf.cu) and their plain twins.

`crf_fwd` computes what the TPU kernel taiyaki_tpu/ops/pallas_crf.py:423
`crf_forward_fused` computes and `crf_bwd` what pallas_crf.py:565
`crf_backward_fused` computes, with the same arguments: transition scores
lp [T, B, S] (already sharpened) and per-row int32 index vectors [B, L]:
stay_idx, move_idx (the move from position l to l+1), modmove_idx and
modmove_fact (the weighted cat_mod column; fact 0 for canonical models),
an index outside [0, S) selecting nothing, and valid [B, L] (int32, 0
past the row's sequence).  L need not be padded to 128 lanes and T needs
no padding.

Impossible states hold NEG = -1e30 as in the JAX package's scan, so a row
with no path keeps finite values and gets all-zero posteriors.

On a CPU tensor the plain PyTorch twins run; on a CUDA tensor the kernels
launch, or the wrappers raise.
"""

import torch

from taiyaki_tpu_torch.ops import cuda_lib

NEG = -1e30
MAX_L = 8192     # 256 threads x up to 32 positions each (csrc/crf.cu)
MAX_S = 128
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_crf_fwd": [_P] * 9 + [_I] * 4 + [_P],
               "tt_crf_bwd": [_P] * 9 + [_I] * 4 + [_P]}


def _select(lp_t, idx):
    """lp_t [B, S] at idx [B, L]; 0 where idx is outside [0, S)."""
    S = lp_t.shape[1]
    ok = (idx >= 0) & (idx < S)
    vals = lp_t.gather(1, idx.clamp(0, S - 1).long())
    return torch.where(ok, vals, torch.zeros_like(vals))


def _move_scores(lp_t, move_idx, modmove_idx, modmove_fact):
    return (_select(lp_t, move_idx)
            + modmove_fact * _select(lp_t, modmove_idx))


def _neg_like(x):
    return torch.full_like(x, NEG)


def crf_fwd_plain(lp, stay_idx, move_idx, modmove_idx, modmove_fact, valid,
                  emit_lattice=True):
    """Plain forward pass.

    Returns:
        (fwd_final [B, L], score [B]: the summed per-step renormalisers,
         without fwd_final at the row's last position, which the caller
         adds; lattice [T, B, L], the renormalised forward vector before
         every step, or None).
    """
    T, B, _ = lp.shape
    L = stay_idx.shape[1]
    ok = valid != 0
    pos = torch.arange(L, device=lp.device)[None, :]
    fwd = torch.where((pos == 0) & ok, torch.zeros(B, L, device=lp.device),
                      torch.full((B, L), NEG, device=lp.device))
    score = lp.new_zeros(B)
    lattice = lp.new_empty(T, B, L) if emit_lattice else None
    neg_col = torch.full((B, 1), NEG, device=lp.device)
    for t in range(T):
        if lattice is not None:
            lattice[t] = fwd
        stay = fwd + _select(lp[t], stay_idx)
        move = fwd + _move_scores(lp[t], move_idx, modmove_idx,
                                  modmove_fact)
        move = torch.cat([neg_col, move[:, :-1]], dim=1)
        new = torch.where(ok, torch.logaddexp(stay, move), _neg_like(stay))
        factor = new.amax(dim=1, keepdim=True)
        fwd = torch.where(ok, new - factor, _neg_like(new))
        score = score + factor[:, 0]
    return fwd, score, lattice


def crf_bwd_plain(lp, stay_idx, move_idx, modmove_idx, modmove_fact,
                  lattice, valid, last):
    """Plain backward pass: d(score)/d(lp) [T, B, S] from the forward
    lattice of `crf_fwd_plain`; `last` [B] is each row's final position."""
    T, B, S = lp.shape
    L = stay_idx.shape[1]
    ok = valid != 0
    pos = torch.arange(L, device=lp.device)[None, :]
    last = last.long()[:, None]
    ok_next = torch.cat([ok[:, 1:], torch.zeros_like(ok[:, :1])], dim=1)
    move_ok = ok & (pos < last) & ok_next
    bwd = torch.where((pos == last) & ok, torch.zeros(B, L, device=lp.device),
                      torch.full((B, L), NEG, device=lp.device))
    neg_col = torch.full((B, 1), NEG, device=lp.device)
    grad = lp.new_zeros(T, B, S)
    sidx = stay_idx.clamp(0, S - 1).long()
    sok = (stay_idx >= 0) & (stay_idx < S)
    midx = move_idx.clamp(0, S - 1).long()
    mok = (move_idx >= 0) & (move_idx < S)
    mmidx = modmove_idx.clamp(0, S - 1).long()
    mmok = (modmove_idx >= 0) & (modmove_idx < S)
    for t in range(T - 1, -1, -1):
        fc = lattice[t]
        stay = _select(lp[t], stay_idx)
        move = _move_scores(lp[t], move_idx, modmove_idx, modmove_fact)
        bwd_next = torch.cat([bwd[:, 1:], neg_col], dim=1)
        stay_terms = torch.where(ok, fc + bwd + stay, _neg_like(fc))
        move_terms = torch.where(move_ok, fc + bwd_next + move, _neg_like(fc))
        tmax = torch.maximum(stay_terms.amax(dim=1, keepdim=True),
                             move_terms.amax(dim=1, keepdim=True))
        ex_s = torch.where(stay_terms > NEG / 2, torch.exp(stay_terms - tmax),
                           torch.zeros_like(fc))
        ex_m = torch.where(move_terms > NEG / 2, torch.exp(move_terms - tmax),
                           torch.zeros_like(fc))
        den = ex_s.sum(dim=1, keepdim=True) + ex_m.sum(dim=1, keepdim=True)
        den = torch.where(den > 0, den, torch.ones_like(den))
        g = grad[t]
        g.scatter_add_(1, sidx, torch.where(sok, ex_s, torch.zeros_like(ex_s)))
        g.scatter_add_(1, midx, torch.where(mok, ex_m, torch.zeros_like(ex_m)))
        g.scatter_add_(1, mmidx, torch.where(mmok, modmove_fact * ex_m,
                                             torch.zeros_like(ex_m)))
        grad[t] = g / den
        mpart = torch.where(move_ok, move + bwd_next, _neg_like(move))
        new = torch.where(ok, torch.logaddexp(stay + bwd, mpart),
                          _neg_like(stay))
        factor = new.amax(dim=1, keepdim=True)
        bwd = torch.where(ok, new - factor, _neg_like(new))
    return grad


def _check(what, device, specs):
    for name, t, shape, dtype in specs:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                "{}: {} must be a contiguous {} tensor of shape {} on {} "
                "(got {} {} {})".format(what, name, dtype, tuple(shape),
                                        device, t.dtype, tuple(t.shape),
                                        t.device))


def _check_inputs(what, lp, stay_idx, move_idx, modmove_idx, modmove_fact,
                  valid):
    cuda_lib.check_cuda(lp, what)
    T, B, S = lp.shape
    L = stay_idx.shape[1]
    _check(what, lp.device, (
        ("lp", lp, (T, B, S), torch.float32),
        ("stay_idx", stay_idx, (B, L), torch.int32),
        ("move_idx", move_idx, (B, L), torch.int32),
        ("modmove_idx", modmove_idx, (B, L), torch.int32),
        ("modmove_fact", modmove_fact, (B, L), torch.float32),
        ("valid", valid, (B, L), torch.int32)))
    if S > MAX_S or L > MAX_L:
        raise ValueError("{}: S {} or L {} beyond the kernel's {} / {}"
                         .format(what, S, L, MAX_S, MAX_L))
    return T, B, S, L


def crf_fwd(lp, stay_idx, move_idx, modmove_idx, modmove_fact, valid,
            emit_lattice=True):
    """CRF forward pass; contract of `crf_fwd_plain`."""
    if lp.device.type == "cpu":
        return crf_fwd_plain(lp, stay_idx, move_idx, modmove_idx,
                             modmove_fact, valid, emit_lattice)
    T, B, S, L = _check_inputs("crf_fwd", lp, stay_idx, move_idx,
                               modmove_idx, modmove_fact, valid)
    lib = cuda_lib.load("crf", _SIGNATURES)
    dev = lp.device
    with torch.cuda.device(dev):
        fwd = torch.empty(B, L, device=dev)
        score = torch.empty(B, device=dev)
        lattice = torch.empty(T, B, L, device=dev) if emit_lattice else None
        err = lib.tt_crf_fwd(
            cuda_lib.ptr(lp), cuda_lib.ptr(stay_idx), cuda_lib.ptr(move_idx),
            cuda_lib.ptr(modmove_idx), cuda_lib.ptr(modmove_fact),
            cuda_lib.ptr(valid), cuda_lib.ptr(fwd), cuda_lib.ptr(score),
            cuda_lib.ptr(lattice), T, B, S, L, cuda_lib.stream(dev))
        crf_fwd.launches += 1
    cuda_lib.check(lib, err, "crf_fwd kernel")
    return fwd, score, lattice


def crf_bwd(lp, stay_idx, move_idx, modmove_idx, modmove_fact, lattice,
            valid, last):
    """CRF backward pass; contract of `crf_bwd_plain`."""
    if lp.device.type == "cpu":
        return crf_bwd_plain(lp, stay_idx, move_idx, modmove_idx,
                             modmove_fact, lattice, valid, last)
    T, B, S, L = _check_inputs("crf_bwd", lp, stay_idx, move_idx,
                               modmove_idx, modmove_fact, valid)
    _check("crf_bwd", lp.device, (
        ("lattice", lattice, (T, B, L), torch.float32),
        ("last", last, (B,), torch.int32)))
    lib = cuda_lib.load("crf", _SIGNATURES)
    dev = lp.device
    with torch.cuda.device(dev):
        grad = torch.empty(T, B, S, device=dev)
        err = lib.tt_crf_bwd(
            cuda_lib.ptr(lp), cuda_lib.ptr(stay_idx), cuda_lib.ptr(move_idx),
            cuda_lib.ptr(modmove_idx), cuda_lib.ptr(modmove_fact),
            cuda_lib.ptr(lattice), cuda_lib.ptr(valid), cuda_lib.ptr(last),
            cuda_lib.ptr(grad), T, B, S, L, cuda_lib.stream(dev))
        crf_bwd.launches += 1
    cuda_lib.check(lib, err, "crf_bwd kernel")
    return grad


crf_fwd.launches = 0
crf_bwd.launches = 0
