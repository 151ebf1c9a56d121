"""Flip-flop partition function: CUDA kernels (csrc/logz.cu) and their
plain twins.

`logz_fwd` computes what the TPU kernel taiyaki_tpu/ops/pallas_logz.py:142
`logz_forward` computes and `logz_posteriors` what pallas_logz.py:249
`logz_backward_posteriors` computes, on unpadded [T, B, S] scores
(S = 2*nbase*(nbase+1) transitions; the TPU's 128-lane and block_t
padding is gone).

Lattice conventions (taiyaki_tpu/flipflopfings.py): nff = 2*nbase states,
transition column j = row*nff + src, rows 0..nbase-1 move into flip base
`row` from any source, row nbase holds flip src -> flop src (src < nbase)
and flop stays (src >= nbase).

A row with no path (every transition impossible, -inf) keeps -inf
vectors, logZ -inf and all-zero posteriors instead of NaN.

Both passes' kernels cut T into segments of K steps (csrc/logz.cu): each
segment's NFF x NFF transfer in parallel, a serial pass over the segments
for the vector at each segment's start (forward) or end (posteriors),
then each segment's steps rerun from it in parallel; the forward's logZ
is the segments' sums added in segment order.  `logz_fwd_segmented` and
`logz_posteriors_segmented` are plain mirrors of that arithmetic, held
against the twins by the CPU tests; nothing on the main path calls them.
The kernels take any contiguous f32 view (4-byte loads where one is not
16-byte aligned).

On a CPU tensor the plain PyTorch twins run; on a CUDA tensor the kernels
launch, or the wrappers raise.
"""

import math

import torch

from taiyaki_tpu_torch import flipflopfings
from taiyaki_tpu_torch.ops import cuda_lib

MAX_NBASE = 8   # kernels are instantiated for nbase 1..8 (csrc/logz.cu)
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_logz_fwd": [_P] * 5 + [_I] * 3 + [_P],
               "tt_logz_fwd_segment": [_I] * 3,
               "tt_logz_fwd_kernels": [_I] * 3,
               "tt_logz_fwd_scratch": [_I] * 3,
               "tt_logz_posteriors": [_P] * 3 + [_I] * 3 + [_P],
               "tt_logz_post_segment": [_I] * 3,
               "tt_logz_post_kernels": [_I] * 3}


def _lattice_maps(nbase, device):
    """(src [S], dst [S]) state index of every transition column."""
    nff = 2 * nbase
    j = torch.arange(nff * (nbase + 1), device=device)
    src = j % nff
    row = j // nff
    dst = torch.where(row < nbase, row, nbase + src % nbase)
    return src, dst


def logz_fwd_plain(scores, nbase, emit_lattice=True):
    """Plain forward pass.

    Args:
        scores: [T, B, S] f32 transition scores.
        nbase: number of canonical bases (S = 2*nbase*(nbase+1)).
        emit_lattice: also return the renormalised forward vector before
            every step.

    Returns:
        (fwd_final [B, 2nb], logz [B] without the initial log(nbase) term,
         lattice [T, B, 2nb] or None).
    """
    T, B, _ = scores.shape
    nff = 2 * nbase
    src, _ = _lattice_maps(nbase, scores.device)
    fwd = torch.cat([
        torch.full((B, nbase), -math.log(nbase), device=scores.device),
        torch.full((B, nbase), -math.inf, device=scores.device)], dim=1)
    logz = scores.new_zeros(B)
    lattice = scores.new_empty(T, B, nff) if emit_lattice else None
    for t in range(T):
        if lattice is not None:
            lattice[t] = fwd
        cand = (fwd[:, src] + scores[t]).view(B, nbase + 1, nff)
        flip = torch.logsumexp(cand[:, :nbase], dim=2)
        flop = torch.logaddexp(cand[:, nbase, :nbase], cand[:, nbase, nbase:])
        new = torch.cat([flip, flop], dim=1)
        factor = torch.logsumexp(new, dim=1, keepdim=True)
        fwd = torch.where(factor > -math.inf, new - factor,
                          torch.full_like(new, -math.inf))
        logz = logz + factor[:, 0]
    return fwd, logz, lattice


def _fwd_step(v, sc, nbase):
    """One step of the forward recursion on v [..., nff] with scores sc
    [..., S], unrenormalised: each flip base the logsumexp over every
    source, each flop base over its flip base and itself."""
    nff = 2 * nbase
    src, _ = _lattice_maps(nbase, v.device)
    cand = (v[..., src] + sc).unflatten(-1, (nbase + 1, nff))
    flip = torch.logsumexp(cand[..., :nbase, :], dim=-1)
    flop = torch.logsumexp(torch.stack([cand[..., nbase, :nbase],
                                        cand[..., nbase, nbase:]]), dim=0)
    return torch.cat([flip, flop], dim=-1)


def _renorm(new, factor):
    return torch.where(factor > -math.inf, new - factor,
                       torch.full_like(new, -math.inf))


def logz_fwd_segmented(scores, nbase, segment, emit_lattice=True):
    """Plain mirror of the forward kernels' segmented arithmetic
    (csrc/logz.cu): segments of `segment` steps, (a) the transfer of every
    segment but the last, its NFF rows run from the unit vectors and
    renormalised by their joint max every step, (b) the serial pass over
    the segments for each one's start vector, renormalised to logsumexp
    0, (c) each segment rerun from it, its lattice rows and the sum of its
    factors; logZ the segments' sums added in segment order.  Contract of
    `logz_fwd_plain`."""
    T, B, _ = scores.shape
    dev = scores.device
    nff = 2 * nbase
    K = max(1, segment)
    nseg = max(1, -(-T // K))
    neg = torch.tensor(-math.inf, device=dev)
    start = torch.cat([torch.full((B, nbase), -math.log(nbase), device=dev),
                       torch.full((B, nbase), -math.inf, device=dev)], dim=1)
    # (a) transfers of segments 0 .. nseg - 2, [B, g, s, d]: all K steps
    eye = torch.eye(nff, dtype=torch.bool, device=dev)
    c = torch.where(eye, 0.0, neg).expand(B, nseg - 1, nff, nff).clone()
    for k in range(K if nseg > 1 else 0):
        t = torch.arange(nseg - 1, device=dev) * K + k
        sc = scores[t].transpose(0, 1)[:, :, None, :]
        new = _fwd_step(c, sc, nbase)
        m = new.amax(dim=(2, 3), keepdim=True)
        c = torch.where(m > -math.inf, new - m, neg)
    # (b) the start vector of every segment
    v = start
    starts = [v]
    for g in range(nseg - 1):
        w = torch.logsumexp(v[:, :, None] + c[:, g], dim=1)
        v = _renorm(w, torch.logsumexp(w, dim=1, keepdim=True))
        starts.append(v)
    # (c) every segment rerun from its start vector
    v = torch.stack(starts, dim=1)
    sums = scores.new_zeros(B, nseg)
    lattice = scores.new_empty(T, B, nff) if emit_lattice else None
    for k in range(K):
        t = torch.arange(nseg, device=dev) * K + k
        step = t < T
        if not step.any():
            break
        if lattice is not None:
            lattice[t[step]] = v[:, step].transpose(0, 1)
        sc = scores[t.clamp(max=T - 1)].transpose(0, 1)
        new = _fwd_step(v, sc, nbase)
        f = torch.logsumexp(new, dim=2, keepdim=True)
        v = torch.where(step[None, :, None], _renorm(new, f), v)
        sums = sums + torch.where(step[None, :], f[..., 0], 0.0)
    logz = scores.new_zeros(B)
    for g in range(nseg):
        logz = logz + sums[:, g]
    return v[:, -1], logz, lattice


def logz_posteriors_plain(scores, lattice, nbase):
    """Plain reverse pass: per-step posterior over the S transitions
    (= d logZ / d scores) from the forward lattice.

    Returns:
        post [T, B, S] f32; all-zero at steps of a row with no path.
    """
    T, B, S = scores.shape
    nff = 2 * nbase
    src, dst = _lattice_maps(nbase, scores.device)
    bwd = torch.full((B, nff), -math.log(nff), device=scores.device)
    post = scores.new_empty(T, B, S)
    for t in range(T - 1, -1, -1):
        out_terms = scores[t] + bwd[:, dst]
        terms = lattice[t][:, src] + out_terms
        m = terms.amax(dim=1, keepdim=True)
        ok = m > -math.inf
        ex = torch.exp(terms - torch.where(ok, m, torch.zeros_like(m)))
        post[t] = ex / torch.where(ok, ex.sum(dim=1, keepdim=True), 1.0)
        new = torch.logsumexp(out_terms.view(B, nbase + 1, nff), dim=1)
        factor = new.amax(dim=1, keepdim=True)
        bwd = torch.where(factor > -math.inf, new - factor,
                          torch.full_like(new, -math.inf))
    return post


def logz_posteriors_segmented(scores, lattice, nbase, segment):
    """Plain mirror of the posterior kernels' segmented arithmetic
    (csrc/logz.cu): segments of `segment` steps (at least 2), (a) each
    segment's transfer but the first's, its NFF columns run from the unit
    vectors and renormalised by their joint max every step, (b) the serial
    pass over segments for each segment's end vector, (c) each segment
    rerun from it, a step's posteriors e_j exp(lattice[s] + m_s - M) /
    sum_s exp(lattice[s] + new[s] - M) from the recursion's own terms.
    Contract of `logz_posteriors_plain`."""
    T, B, S = scores.shape
    dev = scores.device
    nff = 2 * nbase
    K = max(2, segment)
    nseg = -(-T // K)
    _, dst = _lattice_maps(nbase, dev)
    neg = torch.tensor(-math.inf, device=dev)
    g_all = torch.arange(nseg, device=dev)
    # (a) transfers P[b, g - 1] of segments g = 1 .. nseg - 1: [s, d]
    eye = torch.eye(nff, dtype=torch.bool, device=dev)
    c = torch.where(eye, 0.0, neg).expand(B, nseg - 1, nff, nff).clone()
    for k in range(K):
        t = (g_all[1:] + 1) * K - 1 - k
        step = t < T
        sc = scores[t.clamp(max=T - 1)].transpose(0, 1)
        o = (sc[..., None] + c[:, :, dst, :]).view(
            B, nseg - 1, nbase + 1, nff, nff)
        new = torch.where(step[None, :, None, None],
                          torch.logsumexp(o, dim=2), c)
        m = new.amax(dim=(2, 3), keepdim=True)
        c = torch.where(m > -math.inf, new - m, neg)
    # (b) the end vector of every segment, the last's the recursion's start
    v = torch.full((B, nff), -math.log(nff), device=dev)
    ends = [v] * nseg
    for g in range(nseg - 1, 0, -1):
        w = torch.logsumexp(c[:, g - 1] + v[:, None, :], dim=2)
        m = w.amax(dim=1, keepdim=True)
        v = torch.where(m > -math.inf, w - m, neg)
        ends[g - 1] = v
    # (c) every segment rerun from its end vector
    v = torch.stack(ends, dim=1)
    post = scores.new_zeros(T, B, S)
    for k in range(K):
        t = (g_all + 1) * K - 1 - k
        step = t < T
        tc = t.clamp(max=T - 1)
        o = (scores[tc].transpose(0, 1) + v[:, :, dst]).view(
            B, nseg, nbase + 1, nff)
        mx = o.amax(dim=2)
        e = torch.exp(o - torch.where(mx > -math.inf, mx, 0.0)[:, :, None])
        nw = torch.where(mx > -math.inf, mx + torch.log(e.sum(dim=2)), neg)
        fw = lattice[tc].transpose(0, 1)
        big = (fw + nw).amax(dim=2, keepdim=True)
        ok = big > -math.inf
        shift = torch.where(ok, big, 0.0)
        den = torch.exp(fw + nw - shift).sum(dim=2, keepdim=True)
        r = torch.where(ok, torch.exp(fw + mx - shift) / den, 0.0)
        p = (e * r[:, :, None]).reshape(B, nseg, S)
        post[t[step]] = p[:, step].transpose(0, 1)
        f = nw.amax(dim=2, keepdim=True)
        nv = torch.where(f > -math.inf, nw - f, neg)
        v = torch.where(step[None, :, None], nv, v)
    return post


def _check_nbase(nbase, what):
    if not 1 <= nbase <= MAX_NBASE:
        raise ValueError("{}: nbase {} outside 1..{}".format(
            what, nbase, MAX_NBASE))


def _check(name, t, shape, device, what):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            "{}: {} must be a contiguous float32 tensor of shape {} on {} "
            "(got {} {} {})".format(what, name, tuple(shape), device,
                                    t.dtype, tuple(t.shape), t.device))


def logz_fwd(scores, emit_lattice=True):
    """Forward pass of the flip-flop partition function; contract of
    `logz_fwd_plain`, with nbase inferred from S."""
    nbase = flipflopfings.nbase_flipflop(scores.shape[2])
    if scores.device.type == "cpu":
        return logz_fwd_plain(scores, nbase, emit_lattice)
    cuda_lib.check_cuda(scores, "logz_fwd")
    T, B, S = scores.shape
    _check_nbase(nbase, "logz_fwd")
    _check("scores", scores, (T, B, S), scores.device, "logz_fwd")
    nff = 2 * nbase
    lib = cuda_lib.load("logz", _SIGNATURES)
    dev = scores.device
    with torch.cuda.device(dev):
        fwd = torch.empty(B, nff, device=dev)
        logz = torch.empty(B, device=dev)
        lattice = torch.empty(T, B, nff, device=dev) if emit_lattice else None
        n = lib.tt_logz_fwd_scratch(T, B, nbase)
        scratch = torch.empty(n, device=dev) if n else None
        err = lib.tt_logz_fwd(
            cuda_lib.ptr(scores), cuda_lib.ptr(fwd), cuda_lib.ptr(logz),
            cuda_lib.ptr(lattice), cuda_lib.ptr(scratch), T, B, nbase,
            cuda_lib.stream(dev))
        if B:
            logz_fwd.launches += forward_kernels(T, B, nbase)
    cuda_lib.check(lib, err, "logz_fwd kernel")
    return fwd, logz, lattice


def logz_posteriors(scores, lattice):
    """Posterior transition probabilities from scores and the forward
    lattice of `logz_fwd`; contract of `logz_posteriors_plain`."""
    nbase = flipflopfings.nbase_flipflop(scores.shape[2])
    if scores.device.type == "cpu":
        return logz_posteriors_plain(scores, lattice, nbase)
    cuda_lib.check_cuda(scores, "logz_posteriors")
    T, B, S = scores.shape
    _check_nbase(nbase, "logz_posteriors")
    _check("scores", scores, (T, B, S), scores.device, "logz_posteriors")
    _check("lattice", lattice, (T, B, 2 * nbase), scores.device,
           "logz_posteriors")
    lib = cuda_lib.load("logz", _SIGNATURES)
    with torch.cuda.device(scores.device):
        post = torch.empty(T, B, S, device=scores.device)
        err = lib.tt_logz_posteriors(
            cuda_lib.ptr(scores), cuda_lib.ptr(lattice), cuda_lib.ptr(post),
            T, B, nbase, cuda_lib.stream(scores.device))
        if T and B:
            logz_posteriors.launches += posterior_kernels(T, B, nbase)
    cuda_lib.check(lib, err, "logz_posteriors kernels")
    return post


def forward_segment(T, B, nbase):
    """The segment length the forward kernels take at this shape."""
    return cuda_lib.load("logz", _SIGNATURES).tt_logz_fwd_segment(T, B,
                                                                 nbase)


def forward_kernels(T, B, nbase):
    """The kernels one `logz_fwd` call launches at this shape: 3
    (transfers, boundaries, rerun), or 1 when T is one segment."""
    return cuda_lib.load("logz", _SIGNATURES).tt_logz_fwd_kernels(T, B,
                                                                 nbase)


def posterior_segment(T, B, nbase):
    """The segment length the posterior kernels take at this shape."""
    return cuda_lib.load("logz", _SIGNATURES).tt_logz_post_segment(T, B,
                                                                  nbase)


def posterior_kernels(T, B, nbase):
    """The kernels one `logz_posteriors` call launches at this shape: 3
    (transfers, boundaries, posteriors), or 1 when T is one segment."""
    return cuda_lib.load("logz", _SIGNATURES).tt_logz_post_kernels(T, B,
                                                                  nbase)


logz_fwd.launches = 0
logz_posteriors.launches = 0
