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

Each kernel has two more instances, the JAX trainer's mixed precision
(ops/flipflop.py runs them under TAIYAKI_TPU_BF16_STREAMS=1): bf16
scores, a bf16 lattice and bf16 posteriors; and, under
TAIYAKI_TPU_F32_SCORES=1 (and in the basecall), f32 scores with a bf16
lattice and bf16 posteriors, since taiyaki_tpu/ops/flipflop.py:595-623
keeps logZ's lattice and posteriors bf16 whatever the scores' dtype.
Arithmetic, carries and logZ stay f32.  The twins round where the TPU
kernels round: the forward stores each lattice row as bf16 from its f32
vector and goes on from the f32 vector (pallas_logz.py:100-140); the
posteriors are formed in f32 from the bf16 lattice widened and stored as
bf16 (pallas_logz.py:207-248).  The posterior kernels rerun each segment
from its end vector but read the bf16 lattice row at every step, as the
TPU kernel does, so they round at the same points; the segments change
only the f32 order of the backward vector's sums.  A call's (scores,
lattice and posteriors) dtypes are one of `INSTANCES`.

On a CPU tensor the plain PyTorch twins run; on a CUDA tensor the kernels
launch, or the wrappers raise.
"""

import math

import torch

from taiyaki_tpu_torch import flipflopfings
from taiyaki_tpu_torch.ops import cuda_lib
from taiyaki_tpu_torch.ops.rnn_plan import Launches

MAX_NBASE = 8   # kernels are instantiated for nbase 1..8 (csrc/logz.cu)
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_logz_fwd": [_P] * 5 + [_I] * 5 + [_P],
               "tt_logz_fwd_segment": [_I] * 3,
               "tt_logz_fwd_kernels": [_I] * 3,
               "tt_logz_fwd_scratch": [_I] * 3,
               "tt_logz_posteriors": [_P] * 3 + [_I] * 5 + [_P],
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


def logz_fwd_plain(scores, nbase, emit_lattice=True, lattice_dtype=None):
    """Plain forward pass.

    Args:
        scores: [T, B, S] f32 or bf16 transition scores.
        nbase: number of canonical bases (S = 2*nbase*(nbase+1)).
        emit_lattice: also return the renormalised forward vector before
            every step.
        lattice_dtype: the lattice's dtype (None: the scores'); a bf16
            lattice is each f32 vector rounded.

    Returns:
        (fwd_final [B, 2nb] f32, logz [B] f32 without the initial
         log(nbase) term, lattice [T, B, 2nb] or None).
    """
    lattice_dtype = lattice_dtype or scores.dtype
    scores = scores.float()
    T, B, _ = scores.shape
    nff = 2 * nbase
    src, _ = _lattice_maps(nbase, scores.device)
    fwd = torch.cat([
        torch.full((B, nbase), -math.log(nbase), device=scores.device),
        torch.full((B, nbase), -math.inf, device=scores.device)], dim=1)
    logz = scores.new_zeros(B)
    lattice = (scores.new_empty(T, B, nff, dtype=lattice_dtype)
               if emit_lattice else None)
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


def logz_fwd_segmented(scores, nbase, segment, emit_lattice=True,
                       lattice_dtype=None):
    """Plain mirror of the forward kernels' segmented arithmetic
    (csrc/logz.cu): segments of `segment` steps, (a) the transfer of every
    segment but the last, its NFF rows run from the unit vectors and
    renormalised by their joint max every step, (b) the serial pass over
    the segments for each one's start vector, renormalised to logsumexp
    0, (c) each segment rerun from it, its lattice rows and the sum of its
    factors; logZ the segments' sums added in segment order.  Contract of
    `logz_fwd_plain`."""
    lattice_dtype = lattice_dtype or scores.dtype
    scores = scores.float()
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
    lattice = (scores.new_empty(T, B, nff, dtype=lattice_dtype)
               if emit_lattice else None)
    for k in range(K):
        t = torch.arange(nseg, device=dev) * K + k
        step = t < T
        if not step.any():
            break
        if lattice is not None:
            lattice[t[step]] = v[:, step].transpose(0, 1).to(lattice.dtype)
        sc = scores[t.clamp(max=T - 1)].transpose(0, 1)
        new = _fwd_step(v, sc, nbase)
        f = torch.logsumexp(new, dim=2, keepdim=True)
        v = torch.where(step[None, :, None], _renorm(new, f), v)
        sums = sums + torch.where(step[None, :], f[..., 0], 0.0)
    logz = scores.new_zeros(B)
    for g in range(nseg):
        logz = logz + sums[:, g]
    return v[:, -1], logz, lattice


def logz_posteriors_plain(scores, lattice, nbase, out_dtype=None):
    """Plain reverse pass: per-step posterior over the S transitions
    (= d logZ / d scores) from the forward lattice, formed in f32 from the
    scores and lattice widened.

    Returns:
        post [T, B, S] of out_dtype (None: the scores'; bf16 each f32
        posterior rounded); all-zero at steps of a row with no path.
    """
    out_dtype = out_dtype or scores.dtype
    scores, lattice = scores.float(), lattice.float()
    T, B, S = scores.shape
    nff = 2 * nbase
    src, dst = _lattice_maps(nbase, scores.device)
    bwd = torch.full((B, nff), -math.log(nff), device=scores.device)
    post = scores.new_empty(T, B, S, dtype=out_dtype)
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


def logz_posteriors_segmented(scores, lattice, nbase, segment,
                              out_dtype=None):
    """Plain mirror of the posterior kernels' segmented arithmetic
    (csrc/logz.cu): segments of `segment` steps (at least 2), (a) each
    segment's transfer but the first's, its NFF columns run from the unit
    vectors and renormalised by their joint max every step, (b) the serial
    pass over segments for each segment's end vector, (c) each segment
    rerun from it, a step's posteriors e_j exp(lattice[s] + m_s - M) /
    sum_s exp(lattice[s] + new[s] - M) from the recursion's own terms.
    Contract of `logz_posteriors_plain`."""
    out_dtype = out_dtype or scores.dtype
    scores, lattice = scores.float(), lattice.float()
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
    post = scores.new_zeros(T, B, S, dtype=out_dtype)
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
        post[t[step]] = p[:, step].transpose(0, 1).to(post.dtype)
        f = nw.amax(dim=2, keepdim=True)
        nv = torch.where(f > -math.inf, nw - f, neg)
        v = torch.where(step[None, :, None], nv, v)
    return post


def _check_nbase(nbase, what):
    if not 1 <= nbase <= MAX_NBASE:
        raise ValueError("{}: nbase {} outside 1..{}".format(
            what, nbase, MAX_NBASE))


def _check(name, t, shape, device, what, dtype=torch.float32):
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            "{}: {} must be a contiguous {} tensor of shape {} on {} "
            "(got {} {} {})".format(what, name, dtype, tuple(shape), device,
                                    t.dtype, tuple(t.shape), t.device))


# the (scores, lattice and posteriors) dtypes of the kernels' instances:
# f32, bf16, and f32 scores with a bf16 lattice and posteriors
INSTANCES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))


def check_instance(what, scores, lattice, *post):
    """A call's dtypes are an instance's: (scores, lattice) one of
    INSTANCES, the posteriors the lattice's (logZ's kernels, and the CRF's
    on score streams, the scores there the streams)."""
    if (scores, lattice) not in INSTANCES or any(p != lattice for p in post):
        raise ValueError(
            "{}: (scores, lattice, posteriors) dtypes {} are no instance's; "
            "(scores, lattice and posteriors) must be one of {}".format(
                what, (scores, lattice) + post, INSTANCES))


def instance_flags(scores, lattice):
    """The C entry points' instance flags: bf16 scores, a bf16 lattice."""
    return int(scores == torch.bfloat16), int(lattice == torch.bfloat16)


def logz_fwd(scores, emit_lattice=True, lattice_dtype=None):
    """Forward pass of the flip-flop partition function; contract of
    `logz_fwd_plain`, with nbase inferred from S.  The lattice's dtype
    (None: the scores') and the scores' pick the instance (INSTANCES)."""
    nbase = flipflopfings.nbase_flipflop(scores.shape[2])
    lattice_dtype = lattice_dtype or scores.dtype
    check_instance("logz_fwd", scores.dtype, lattice_dtype)
    if scores.device.type == "cpu":
        return logz_fwd_plain(scores, nbase, emit_lattice, lattice_dtype)
    cuda_lib.check_cuda(scores, "logz_fwd")
    T, B, S = scores.shape
    _check_nbase(nbase, "logz_fwd")
    _check("scores", scores, (T, B, S), scores.device, "logz_fwd",
           scores.dtype)
    nff = 2 * nbase
    lib = cuda_lib.load("logz", _SIGNATURES)
    dev = scores.device
    with torch.cuda.device(dev):
        fwd = torch.empty(B, nff, device=dev)
        logz = torch.empty(B, device=dev)
        lattice = (torch.empty(T, B, nff, device=dev, dtype=lattice_dtype)
                   if emit_lattice else None)
        n = lib.tt_logz_fwd_scratch(T, B, nbase)
        scratch = torch.empty(n, device=dev) if n else None
        err = lib.tt_logz_fwd(
            cuda_lib.ptr(scores), cuda_lib.ptr(fwd), cuda_lib.ptr(logz),
            cuda_lib.ptr(lattice), cuda_lib.ptr(scratch), T, B, nbase,
            *instance_flags(scores.dtype, lattice_dtype), cuda_lib.stream(dev))
        if B:
            n = forward_kernels(T, B, nbase)
            logz_fwd.launches += n
            count_instance(logz_fwd, scores.dtype, lattice_dtype, n)
    cuda_lib.check(lib, err, "logz_fwd kernel")
    return fwd, logz, lattice


def logz_posteriors(scores, lattice, out_dtype=None):
    """Posterior transition probabilities from scores and the forward
    lattice of `logz_fwd`; contract of `logz_posteriors_plain`.  The
    posteriors' dtype (None: the scores') is the lattice's, and with the
    scores' picks the instance (INSTANCES)."""
    nbase = flipflopfings.nbase_flipflop(scores.shape[2])
    out_dtype = out_dtype or scores.dtype
    check_instance("logz_posteriors", scores.dtype, lattice.dtype, out_dtype)
    if scores.device.type == "cpu":
        return logz_posteriors_plain(scores, lattice, nbase, out_dtype)
    cuda_lib.check_cuda(scores, "logz_posteriors")
    T, B, S = scores.shape
    _check_nbase(nbase, "logz_posteriors")
    _check("scores", scores, (T, B, S), scores.device, "logz_posteriors",
           scores.dtype)
    _check("lattice", lattice, (T, B, 2 * nbase), scores.device,
           "logz_posteriors", out_dtype)
    lib = cuda_lib.load("logz", _SIGNATURES)
    with torch.cuda.device(scores.device):
        post = torch.empty(T, B, S, device=scores.device, dtype=out_dtype)
        err = lib.tt_logz_posteriors(
            cuda_lib.ptr(scores), cuda_lib.ptr(lattice), cuda_lib.ptr(post),
            T, B, nbase, *instance_flags(scores.dtype, out_dtype),
            cuda_lib.stream(scores.device))
        if T and B:
            n = posterior_kernels(T, B, nbase)
            logz_posteriors.launches += n
            count_instance(logz_posteriors, scores.dtype, out_dtype, n)
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


def count_instance(fn, scores, lattice, n=1):
    """n launches of `fn`'s instance on these dtypes, on its counter: `bf16`
    (bf16 scores) or `mixed` (f32 scores, a bf16 lattice)."""
    if lattice == torch.bfloat16:
        (fn.bf16 if scores == torch.bfloat16 else fn.mixed).launches += n


logz_fwd.launches = 0
logz_posteriors.launches = 0
# the bf16 and mixed instances' launches (also counted in `launches`)
logz_fwd.bf16 = Launches()
logz_posteriors.bf16 = Launches()
logz_fwd.mixed = Launches()
logz_posteriors.mixed = Launches()
