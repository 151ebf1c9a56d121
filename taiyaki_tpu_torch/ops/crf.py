"""Flip-flop CRF lattice forward and backward: the CUDA kernels
(csrc/crf.cu) and their plain twins.

Two pairs.  The fused pair (kernels 5-6) selects scores from lp itself;
the streams pair (kernels 9-10) runs the same recursions on stay and move
score streams [T, B, L] that the caller selected (`ops.flipflop` chooses
the pair): `crf_fwd_streams` (kernel 5's chain on another reader), and
the backward, kernel 10, which runs that chain backwards into a backward
lattice and then a posterior pass without a serial chain, with two
entries: `crf_bwd_posteriors` (the posteriors [T, B, L]) and
`crf_grad_streams` (the posteriors summed into d lp [T, B, S] in a fixed
order, no scatter).  The streams pair takes any L: its chains run in a
thread-block cluster up to MAX_L_STREAMS positions (`streams_layout`)
and keep each row's vector in device memory past it.

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

The fused forward (kernel 5) keeps each row's state in registers, a few
consecutive positions a thread, on a layout chosen by L (`fwd_layout`:
one warp a row up to 64 positions, more warps past that, two CTAs past
4096), with its lp rows brought into shared memory a batch ahead.  The
fused backward (kernel 6) runs the backward recursion alone on its serial
chain and forms each batch of steps' posteriors off it, summing them into
the columns of d lp in an order fixed by the row's indices, so its d lp
is bitwise the same from run to run (csrc/crf.cu).

On a CPU tensor the plain PyTorch twins run; on a CUDA tensor the kernels
launch, or the wrappers raise.
"""

import ctypes

import torch

from taiyaki_tpu_torch.ops import cuda_lib

NEG = -1e30
MAX_L = 8192     # the fused kernels' widest lattice (csrc/crf.cu)
MAX_S = 128
# kernels 9-10's chains keep a row's lattice vector in registers, in a
# cluster of up to 8 CTAs, up to this many positions (1024 threads x 4 x
# 8), in device memory past it
MAX_L_STREAMS = 32768
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_crf_fwd": [_P] * 9 + [_I] * 4 + [_P],
               "tt_crf_bwd": [_P] * 9 + [_I] * 4 + [_P],
               "tt_crf_bwd_batch": [_I] * 4,
               "tt_crf_fwd_layout": [_I],
               "tt_crf_fwd_streams": [_P] * 7 + [_I] * 3 + [_P],
               "tt_crf_bwd_posteriors": [_P] * 8 + [_I] * 3 + [_P],
               "tt_crf_grad_streams": [_P] * 11 + [_I] * 4 + [_P],
               "tt_crf_streams_layout": [_I],
               "tt_crf_streams_scratch": [_I] * 5}


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


def fwd_layout(L):
    """The forward kernel's layout at lattice width L: (threads a row,
    positions a thread, CTAs a row); None past MAX_L."""
    packed = cuda_lib.load("crf", _SIGNATURES).tt_crf_fwd_layout(L)
    if not packed:
        return None
    return packed >> 16, (packed >> 8) & 0xff, packed & 0xff


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


# entries a chunk of the backward kernel's column lists (csrc/crf.cu CHUNK)
BWD_CHUNK = 31


def column_lists(stay_idx, move_idx, modmove_idx, modmove_fact, valid, last,
                 S):
    """One row's contributions to the columns of d lp, grouped as the
    backward kernel groups them once per row (csrc/crf.cu): a stable
    counting sort by column, then position, then kind (0 the stay, 1 the
    move, 2 the weighted mod column), column S collecting the stays and
    moves whose index selects nothing (they count in the denominator
    only); each column's list cut into chunks of BWD_CHUNK entries.  Kept
    to test the grouping on the CPU; nothing on the main path calls it.

    Args:
        stay_idx, move_idx, modmove_idx, modmove_fact, valid: [L] tensors
            of one row, as `crf_bwd` takes them; last: its final position.

    Returns:
        (ent [n] int64: 4 * position + kind, in list order; off [S + 2]:
         each column's first entry; choff [S + 2]: its first chunk; chst
         [nchunks + 1]: each chunk's first entry, then n).
    """
    L = stay_idx.shape[0]
    pos = torch.arange(L)
    ok = valid != 0
    ok_next = torch.cat([ok[1:], torch.zeros(1, dtype=torch.bool)])
    mok = ok & (pos < int(last)) & ok_next

    def col(idx):
        idx = idx.long()
        return torch.where((idx >= 0) & (idx < S), idx, torch.full_like(
            idx, S))

    mod = mok & (modmove_fact != 0) & (col(modmove_idx) < S)
    cols = torch.cat([col(stay_idx)[ok], col(move_idx)[mok],
                      col(modmove_idx)[mod]])
    ent = torch.cat([4 * pos[ok], 4 * pos[mok] + 1, 4 * pos[mod] + 2])
    order = torch.argsort(cols * 4 * L + ent, stable=True)
    ent = ent[order]
    cnt = torch.bincount(cols, minlength=S + 1)
    off = torch.cat([torch.zeros(1, dtype=torch.int64), cnt.cumsum(0)])
    nch = (cnt + BWD_CHUNK - 1) // BWD_CHUNK
    choff = torch.cat([torch.zeros(1, dtype=torch.int64), nch.cumsum(0)])
    chst = [int(off[j]) + i * BWD_CHUNK for j in range(S + 1)
            for i in range(int(nch[j]))]
    return ent, off, choff, torch.tensor(chst + [len(ent)])


def bwd_batch(T, B, S, L):
    """The steps a batch of the backward kernel at this shape: the ring of
    backward vectors whose posteriors it forms at once, off its chain."""
    return cuda_lib.load("crf", _SIGNATURES).tt_crf_bwd_batch(T, B, S, L)


crf_fwd.launches = 0
crf_bwd.launches = 0


# -- kernels 9-10: the recursions on selected score streams -------------------

# the stream chains' bands (csrc/crf.cu TT_STREAM_BANDS): (widest L, most
# threads a row, positions a thread, CTAs a row)
STREAM_BANDS = ((64, 32, 2, 1), (1024, 512, 2, 1), (2048, 1024, 2, 1),
                (4096, 1024, 4, 1), (MAX_L, 1024, 4, 2),
                (2 * MAX_L, 1024, 4, 4), (MAX_L_STREAMS, 1024, 4, 8))


def streams_layout(L):
    """The layout of kernels 9-10's chains at lattice width L, as csrc/
    crf.cu's TT_STREAM_BANDS picks it (tt_crf_streams_layout): (threads a
    row, positions a thread, CTAs a row), the fewest warps of its band that
    hold L, at least two where a row is more than one warp; None past
    MAX_L_STREAMS, where the chains keep the row's vector in device
    memory."""
    for top, most, p, cl in STREAM_BANDS:
        if 1 <= L <= top:
            if most == 32:
                return 32, p, cl
            return 32 * max(2, -(-L // (32 * p * cl))), p, cl
    return None


def crf_fwd_streams_plain(stay_all, move_all, valid, emit_lattice=True):
    """Plain forward pass on score streams, as pallas_crf.crf_forward
    computes it: stay_all, move_all [T, B, L] (move column l is the move
    l -> l+1), valid [B, L].

    Returns:
        (fwd_final [B, L], score [B]: the summed per-step renormalisers,
         without fwd_final at the row's last position; lattice [T, B, L],
         the renormalised forward vector before every step, or None).
    """
    T, B, L = stay_all.shape
    dev = stay_all.device
    ok = valid != 0
    pos = torch.arange(L, device=dev)[None, :]
    fwd = torch.where((pos == 0) & ok, torch.zeros(B, L, device=dev),
                      torch.full((B, L), NEG, device=dev))
    score = stay_all.new_zeros(B)
    lattice = stay_all.new_empty(T, B, L) if emit_lattice else None
    neg_col = torch.full((B, 1), NEG, device=dev)
    for t in range(T):
        if lattice is not None:
            lattice[t] = fwd
        move = torch.cat([neg_col, fwd[:, :-1] + move_all[t, :, :-1]], dim=1)
        new = torch.logaddexp(fwd + stay_all[t], move)
        new = torch.where(ok, new, _neg_like(new))
        factor = new.amax(dim=1, keepdim=True)
        fwd = torch.where(ok, new - factor, _neg_like(new))
        score = score + factor[:, 0]
    return fwd, score, lattice


def _bwd_start(valid, last):
    """(ok, move_ok, the backward vector before the last step) of rows
    with final positions `last`."""
    B, L = valid.shape
    dev = valid.device
    ok = valid != 0
    pos = torch.arange(L, device=dev)[None, :]
    last = last.long()[:, None]
    bwd = torch.where((pos == last) & ok, torch.zeros(B, L, device=dev),
                      torch.full((B, L), NEG, device=dev))
    return ok, ok & (pos < last), bwd


def crf_bwd_posteriors_plain(stay_all, move_all, lattice, valid, last):
    """Plain backward pass on score streams, as
    pallas_crf.crf_backward_posteriors computes it.

    Returns:
        (post_stay [T, B, L], post_move [T, B, L]): each step's posterior
        over its 2L-1 transitions; post_move column l is the move
        l -> l+1.  A row with no path gets zeros.
    """
    T, B, L = stay_all.shape
    ok, move_ok, bwd = _bwd_start(valid, last)
    neg_col = torch.full((B, 1), NEG, device=stay_all.device)
    post_stay = stay_all.new_empty(T, B, L)
    post_move = stay_all.new_empty(T, B, L)
    for t in range(T - 1, -1, -1):
        fc, stay, move = lattice[t], stay_all[t], move_all[t]
        bwd_shift = torch.cat([bwd[:, 1:], neg_col], dim=1)
        stay_terms = torch.where(ok, fc + bwd + stay, _neg_like(fc))
        move_terms = torch.where(move_ok, fc + bwd_shift + move,
                                 _neg_like(fc))
        tmax = torch.maximum(stay_terms.amax(dim=1, keepdim=True),
                             move_terms.amax(dim=1, keepdim=True))
        ex_s = torch.where(stay_terms > NEG / 2, torch.exp(stay_terms - tmax),
                           torch.zeros_like(fc))
        ex_m = torch.where(move_terms > NEG / 2, torch.exp(move_terms - tmax),
                           torch.zeros_like(fc))
        den = ex_s.sum(dim=1, keepdim=True) + ex_m.sum(dim=1, keepdim=True)
        den = torch.where(den > 0, den, torch.ones_like(den))
        post_stay[t] = ex_s / den
        post_move[t] = ex_m / den
        mpart = torch.where(move_ok, move + bwd_shift, _neg_like(move))
        new = torch.where(ok, torch.logaddexp(stay + bwd, mpart),
                          _neg_like(stay))
        factor = new.amax(dim=1, keepdim=True)
        bwd = torch.where(ok, new - factor, _neg_like(new))
    return post_stay, post_move


def crf_bwd_chain_plain(stay_all, move_all, valid, last):
    """The backward recursion of `crf_bwd_posteriors_plain` alone, as
    kernel 10's chain runs it: the backward lattice [T, B, L], the
    renormalised backward vector before every step (t = T-1 first)."""
    T, B, L = stay_all.shape
    ok, move_ok, bwd = _bwd_start(valid, last)
    neg_col = torch.full((B, 1), NEG, device=stay_all.device)
    blat = stay_all.new_empty(T, B, L)
    for t in range(T - 1, -1, -1):
        blat[t] = bwd
        bwd_shift = torch.cat([bwd[:, 1:], neg_col], dim=1)
        mpart = torch.where(move_ok, move_all[t] + bwd_shift,
                            _neg_like(bwd))
        new = torch.where(ok, torch.logaddexp(stay_all[t] + bwd, mpart),
                          _neg_like(bwd))
        factor = new.amax(dim=1, keepdim=True)
        bwd = torch.where(ok, new - factor, _neg_like(new))
    return blat


def crf_post_pass_plain(stay_all, move_all, lattice, blat, valid, last):
    """Kernel 10's posterior pass: every step's posteriors at once from the
    forward and backward lattices [T, B, L] (no chain); the contract of
    `crf_bwd_posteriors_plain`."""
    ok, move_ok, _ = _bwd_start(valid, last)
    neg = torch.full_like(blat[:, :, :1], NEG)
    bshift = torch.cat([blat[:, :, 1:], neg], dim=2)
    stay_terms = torch.where(ok, lattice + blat + stay_all, _neg_like(blat))
    move_terms = torch.where(move_ok, lattice + bshift + move_all,
                             _neg_like(blat))
    tmax = torch.maximum(stay_terms.amax(dim=2, keepdim=True),
                         move_terms.amax(dim=2, keepdim=True))
    ex_s = torch.where(stay_terms > NEG / 2, torch.exp(stay_terms - tmax),
                       torch.zeros_like(blat))
    ex_m = torch.where(move_terms > NEG / 2, torch.exp(move_terms - tmax),
                       torch.zeros_like(blat))
    den = ex_s.sum(dim=2, keepdim=True) + ex_m.sum(dim=2, keepdim=True)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return ex_s / den, ex_m / den


def scatter_posteriors(shape, post_stay, post_move, sidx, midx, mmidx,
                       mfact):
    """d(score)/d lp [T, B, S]: the posteriors scattered back into their
    columns (the stay column, the move column and mfact x the mod column;
    mmidx None for a canonical model), an index vector [B, L] clamped into
    [0, S) (the columns it clamps carry zero posteriors or weigh 0).
    scatter_add_ sums with atomics on the card, in an order that changes
    from run to run.  post_move is scaled in place."""
    T, _, S = shape

    def expand(idx):
        return idx.clamp(0, S - 1).long()[None].expand(T, *idx.shape)
    grad = post_stay.new_zeros(shape)
    grad.scatter_add_(2, expand(sidx), post_stay)
    grad.scatter_add_(2, expand(midx), post_move)
    if mmidx is not None:
        grad.scatter_add_(2, expand(mmidx), post_move.mul_(mfact[None]))
    return grad


def crf_grad_streams_plain(stay_all, move_all, lattice, valid, last, sidx,
                           midx, mmidx, mfact, S):
    """d(score)/d lp [T, B, S] on score streams: `crf_bwd_posteriors_plain`
    scattered into the columns sidx, midx and mfact x mmidx [B, L] (an
    index outside [0, S) selects nothing) by `scatter_posteriors`."""
    post_stay, post_move = crf_bwd_posteriors_plain(stay_all, move_all,
                                                    lattice, valid, last)
    T, B, _ = stay_all.shape
    return scatter_posteriors((T, B, S), post_stay, post_move, sidx, midx,
                              mmidx, mfact)


def _check_streams(what, stay_all, move_all, valid):
    cuda_lib.check_cuda(stay_all, what)
    T, B, L = stay_all.shape
    _check(what, stay_all.device, (
        ("stay_all", stay_all, (T, B, L), torch.float32),
        ("move_all", move_all, (T, B, L), torch.float32),
        ("valid", valid, (B, L), torch.int32)))
    return T, B, L


def _streams_scratch(lib, T, B, L, S, grad, dev):
    """Kernel 10's scratch (the backward lattice, the chains' vectors past
    MAX_L_STREAMS, the pass's exponentials where they do not fit shared
    memory, the column lists), as csrc/crf.cu sizes it."""
    fn = lib.tt_crf_streams_scratch
    fn.restype = ctypes.c_longlong
    return torch.empty(max(fn(T, B, L, S, int(grad)), 1), device=dev)


def crf_fwd_streams(stay_all, move_all, valid, emit_lattice=True):
    """CRF forward pass on score streams (kernel 9); contract of
    `crf_fwd_streams_plain`."""
    if stay_all.device.type == "cpu":
        return crf_fwd_streams_plain(stay_all, move_all, valid, emit_lattice)
    T, B, L = _check_streams("crf_fwd_streams", stay_all, move_all, valid)
    lib = cuda_lib.load("crf", _SIGNATURES)
    dev = stay_all.device
    with torch.cuda.device(dev):
        fwd = torch.empty(B, L, device=dev)
        score = torch.empty(B, device=dev)
        lattice = torch.empty(T, B, L, device=dev) if emit_lattice else None
        gstate = (torch.empty(B, 2, L, device=dev) if L > MAX_L_STREAMS
                  else None)
        err = lib.tt_crf_fwd_streams(
            cuda_lib.ptr(stay_all), cuda_lib.ptr(move_all),
            cuda_lib.ptr(valid), cuda_lib.ptr(fwd), cuda_lib.ptr(score),
            cuda_lib.ptr(lattice), cuda_lib.ptr(gstate), T, B, L,
            cuda_lib.stream(dev))
        crf_fwd_streams.launches += 1
    cuda_lib.check(lib, err, "crf_fwd_streams kernel")
    return fwd, score, lattice


def crf_bwd_posteriors(stay_all, move_all, lattice, valid, last):
    """CRF backward pass on score streams (kernel 10: the backward chain,
    then the posterior pass); contract of `crf_bwd_posteriors_plain`."""
    if stay_all.device.type == "cpu":
        return crf_bwd_posteriors_plain(stay_all, move_all, lattice, valid,
                                        last)
    T, B, L = _check_streams("crf_bwd_posteriors", stay_all, move_all, valid)
    _check("crf_bwd_posteriors", stay_all.device, (
        ("lattice", lattice, (T, B, L), torch.float32),
        ("last", last, (B,), torch.int32)))
    lib = cuda_lib.load("crf", _SIGNATURES)
    dev = stay_all.device
    with torch.cuda.device(dev):
        post_stay = torch.empty(T, B, L, device=dev)
        post_move = torch.empty(T, B, L, device=dev)
        scratch = _streams_scratch(lib, T, B, L, 0, False, dev)
        err = lib.tt_crf_bwd_posteriors(
            cuda_lib.ptr(stay_all), cuda_lib.ptr(move_all),
            cuda_lib.ptr(lattice), cuda_lib.ptr(valid), cuda_lib.ptr(last),
            cuda_lib.ptr(post_stay), cuda_lib.ptr(post_move),
            cuda_lib.ptr(scratch), T, B, L, cuda_lib.stream(dev))
        crf_bwd_posteriors.launches += 1
    cuda_lib.check(lib, err, "crf_bwd_posteriors kernel")
    return post_stay, post_move


def crf_grad_streams(stay_all, move_all, lattice, valid, last, sidx, midx,
                     mmidx, mfact, S):
    """d(score)/d lp [T, B, S] on score streams (kernel 10: the backward
    chain, the rows' column lists, the posterior pass summing into d lp
    in a fixed order, so bitwise the same from run to run); contract of
    `crf_grad_streams_plain`, with the index vectors of `crf_bwd`
    (mmidx and mfact required: a column outside [0, S) and weight 0 for a
    canonical model)."""
    if stay_all.device.type == "cpu":
        return crf_grad_streams_plain(stay_all, move_all, lattice, valid,
                                      last, sidx, midx, mmidx, mfact, S)
    T, B, L = _check_streams("crf_grad_streams", stay_all, move_all, valid)
    _check("crf_grad_streams", stay_all.device, (
        ("lattice", lattice, (T, B, L), torch.float32),
        ("last", last, (B,), torch.int32),
        ("sidx", sidx, (B, L), torch.int32),
        ("midx", midx, (B, L), torch.int32),
        ("mmidx", mmidx, (B, L), torch.int32),
        ("mfact", mfact, (B, L), torch.float32)))
    lib = cuda_lib.load("crf", _SIGNATURES)
    dev = stay_all.device
    with torch.cuda.device(dev):
        grad = torch.empty(T, B, S, device=dev)
        scratch = _streams_scratch(lib, T, B, L, S, True, dev)
        err = lib.tt_crf_grad_streams(
            cuda_lib.ptr(stay_all), cuda_lib.ptr(move_all),
            cuda_lib.ptr(lattice), cuda_lib.ptr(valid), cuda_lib.ptr(last),
            cuda_lib.ptr(sidx), cuda_lib.ptr(midx), cuda_lib.ptr(mmidx),
            cuda_lib.ptr(mfact), cuda_lib.ptr(grad), cuda_lib.ptr(scratch),
            T, B, L, S, cuda_lib.stream(dev))
        crf_grad_streams.launches += 1
    cuda_lib.check(lib, err, "crf_grad_streams kernel")
    return grad


crf_fwd_streams.launches = 0
crf_bwd_posteriors.launches = 0
crf_grad_streams.launches = 0
