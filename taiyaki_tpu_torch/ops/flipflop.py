"""Flip-flop CRF loss and partition function (port of
taiyaki_tpu/ops/flipflop.py).

`crf_flipflop_loss` and `cat_mod_flipflop_loss` run the CRF lattice
kernels of `ops.crf` (the forward in the forward pass, the backward in
the backward pass) and `flipflop_logz` the logZ kernels of `ops.logz`
(forward and posteriors), each as a `torch.autograd.Function`.  The CRF
takes one of two routes (`use_score_streams`): by default the fused
kernels 5-6, which select scores from lp themselves; or the JAX package's
unfused route, which gathers stay and move score streams [T, B, L] here
and runs kernels 9-10 on them, the backward summing the posteriors into
the columns of d lp itself (`crf.crf_grad_streams`, bitwise the same from
run to run).
Values follow the JAX package's CPU scan: the loss is -score/nblk, zero
for an empty row; logZ counts the initial logsumexp of the start vector,
log(nbase), which the forward kernel leaves out and this module adds
back.
"""

import math
import os

import numpy as np
import torch

from taiyaki_tpu_torch import flipflopfings
from taiyaki_tpu_torch.ops import crf
from taiyaki_tpu_torch.ops.logz import logz_fwd, logz_posteriors


def make_seq_indices(seqs, nbase):
    """Stay/move transition indices for a padded batch of flip-flop codes.

    Args:
        seqs: int tensor [batch, npos] of flip-flop codes, padded with
            valid codes (e.g. 0) past each sequence.
        nbase: number of canonical bases.

    Returns:
        (stay_idx [batch, npos], move_idx [batch, npos-1]) int32 tensors.
    """
    nff = 2 * nbase
    stay_idx = seqs + torch.clamp(seqs, max=nbase) * nff
    move_idx = seqs[:, :-1] + torch.clamp(seqs[:, 1:], max=nbase) * nff
    return stay_idx.int(), move_idx.int()


def _masked_cost(score, seqlens, nblk):
    """cost = -score / nblk; zero for empty sequences."""
    cost = -score / nblk
    return torch.where(seqlens > 0, cost, torch.zeros_like(cost))


def _lattice_inputs(stay_idx, move_idx, seqlens, nstate, modmove_idx=None,
                    modmove_fact=None):
    """The [B, L] index vectors of `ops.crf` (L = npos), move-type columns
    padded past npos-1 with an index that selects nothing; valid; last."""
    B, L = stay_idx.shape
    dev = stay_idx.device
    pad = torch.full((B, 1), nstate, dtype=torch.int32, device=dev)
    midx = torch.cat([move_idx.int(), pad], dim=1)
    if modmove_idx is None:
        mmidx = torch.full((B, L), nstate, dtype=torch.int32, device=dev)
        mfact = torch.zeros(B, L, device=dev)
    else:
        mmidx = torch.cat([modmove_idx.int(), pad], dim=1)
        mfact = torch.cat([modmove_fact.float(),
                           torch.zeros(B, 1, device=dev)], dim=1)
    pos = torch.arange(L, device=dev)[None, :]
    valid = (pos < seqlens[:, None]).int()
    last = torch.clamp(seqlens - 1, 0, L - 1).int()
    return (stay_idx.int().contiguous(), midx.contiguous(),
            mmidx.contiguous(), mfact.contiguous(), valid.contiguous(),
            last.contiguous())


def use_score_streams(nstate, npos):
    """Whether the CRF loss takes the score-stream route (kernels 9-10)
    rather than the fused kernels 5-6: under either of the JAX trainer's
    switches TAIYAKI_TPU_NO_SCORE_FUSE=1 and TAIYAKI_TPU_F32_SCORES=1
    (taiyaki_tpu/ops/flipflop.py `_use_score_fusion`), or for a lattice
    the fused kernels do not take (nstate > crf.MAX_S or npos >
    crf.MAX_L), the counterpart of the JAX package's `_fused_setup`
    finding no tile.  Chosen from switches and shapes alone, before any
    launch."""
    if os.environ.get("TAIYAKI_TPU_NO_SCORE_FUSE") == "1" \
            or os.environ.get("TAIYAKI_TPU_F32_SCORES") == "1":
        return True
    return nstate > crf.MAX_S or npos > crf.MAX_L


def _expand(idx, T, S):
    """An [B, L] index vector as a [T, B, L] view for gather (no copy over
    T), clamped into [0, S): the columns it clamps are masked by position
    in kernels 9-10 (move column L-1 is never a transition) or weigh 0 (a
    mod column's padding)."""
    return idx.clamp(0, S - 1).long()[None].expand(T, *idx.shape)


def _select_streams(lp, sidx, midx, mmidx, mfact):
    """Stay and move score streams [T, B, L] gathered from lp [T, B, S];
    the move stream adds mfact x the cat_mod column (mmidx None for a
    canonical model).  The JAX package's `_select_all_scores`."""
    T, _, S = lp.shape
    stay_all = lp.gather(2, _expand(sidx, T, S))
    move_all = lp.gather(2, _expand(midx, T, S))
    if mmidx is not None:
        # the product and the sum each rounded, as kernels 5-6 fold it
        move_all.add_(lp.gather(2, _expand(mmidx, T, S)).mul_(mfact[None]))
    return stay_all, move_all


# the posteriors scattered into d lp, as the JAX package's route does (its
# einsum); the streams route itself sums them in crf.crf_grad_streams
_scatter_posteriors = crf.scatter_posteriors


class _CrfLossCore(torch.autograd.Function):
    """cost [B] of (sharpened) scores lp [T, B, S]; the gradient is
    -posterior/nblk, zeroed for rows with seqlens == 0.  modmove_idx and
    modmove_fact are None for a canonical model.  The route (fused
    kernels 5-6 or the streams and kernels 9-10) is chosen once per call
    by `use_score_streams`."""

    @staticmethod
    def forward(ctx, lp, stay_idx, move_idx, modmove_idx, modmove_fact,
                seqlens):
        T, _, S = lp.shape
        lp = lp.contiguous()
        idx = _lattice_inputs(stay_idx, move_idx, seqlens, S, modmove_idx,
                              modmove_fact)
        sidx, midx, mmidx, mfact, valid, last = idx
        grad = ctx.needs_input_grad[0]
        ctx.streams = use_score_streams(S, sidx.shape[1])
        if ctx.streams:
            mod = (None, None) if modmove_idx is None else (mmidx, mfact)
            stay_all, move_all = _select_streams(lp, sidx, midx, *mod)
            fwd, score, lattice = crf.crf_fwd_streams(
                stay_all, move_all, valid, emit_lattice=grad)
            saved = (stay_all, move_all) if grad else (None, None)
        else:
            fwd, score, lattice = crf.crf_fwd(lp, sidx, midx, mmidx, mfact,
                                              valid, emit_lattice=grad)
            saved = (lp, None)
        score = score + fwd.gather(1, last.long()[:, None])[:, 0]
        ctx.lp_shape = lp.shape
        ctx.save_for_backward(*saved, lattice, seqlens, *idx)
        return _masked_cost(score, seqlens, T)

    @staticmethod
    def backward(ctx, g):
        # (stay_all, move_all) on the streams route, (lp, None) fused
        first, second, lattice, seqlens, sidx, midx, mmidx, mfact, valid, \
            last = ctx.saved_tensors
        if ctx.streams:
            post = crf.crf_grad_streams(first, second, lattice, valid, last,
                                        sidx, midx, mmidx, mfact,
                                        ctx.lp_shape[2])
        else:
            post = crf.crf_bwd(first, sidx, midx, mmidx, mfact, lattice,
                               valid, last)
        gm = torch.where(seqlens > 0, g, torch.zeros_like(g))
        return ((-post / ctx.lp_shape[0]) * gm[None, :, None], None, None,
                None, None, None)


def crf_flipflop_loss(logprob, seqs, seqlens, sharpfact=1.0):
    """Flip-flop CRF negative-log-conditional-probability per batch row.

    Args:
        logprob: [nblk, batch, nstate] transition weights (not
            normalised; pair with flipflop_logz).
        seqs: [batch, npos] int flip-flop codes, padded to a common length.
        seqlens: [batch] int sequence lengths.
        sharpfact: sharpening factor applied to the scores before the DP;
            the cost is divided by it after.

    Returns:
        [batch] f32 costs = -score / nblk.
    """
    nbase = flipflopfings.nbase_flipflop(logprob.shape[2])
    stay_idx, move_idx = make_seq_indices(seqs, nbase)
    lp = (sharpfact * logprob).float()
    return _CrfLossCore.apply(lp, stay_idx, move_idx, None, None,
                              seqlens) / sharpfact


def cat_mod_flipflop_loss(logprob, seqs, seqlens, mod_cats, can_mods_offsets,
                          mod_cat_weights, sharpfact=1.0):
    """Flip-flop CRF loss with categorical modified-base scores (port of
    taiyaki_tpu/ops/flipflop.py `cat_mod_flipflop_loss`).  Each move into
    position p also scores weight x logprob[mod column of p], the column
    of (canonical base of p, mod category of p) past the 2*nbase*(nbase+1)
    transition columns.

    Sharpening applies to the canonical transition columns only, and the
    gradient is the core DP gradient at the sharpened scores with neither
    the sharpening chain factor nor the 1/sharpfact (straight-through, the
    reference's convention): mod columns get no 1/sharpfact.

    Args:
        logprob: [nblk, batch, nstate] with nstate = 2*nbase*(nbase+1) +
            can_mods_offsets[-1].
        seqs: [batch, npos] padded flip-flop codes.
        seqlens: [batch] sequence lengths.
        mod_cats: [batch, npos] mod category per position (0 = canonical).
        can_mods_offsets: [nbase + 1] ints (numpy), the offset of each
            canonical base's group in the mod columns.
        mod_cat_weights: [can_mods_offsets[-1]] per-category loss weights.
        sharpfact: canonical-column sharpening factor.

    Returns:
        [batch] f32 costs.
    """
    ntrans = logprob.shape[2]
    offsets = np.asarray(can_mods_offsets)
    n_can_trans = ntrans - int(offsets[-1])
    nbase = flipflopfings.nbase_flipflop(n_can_trans)
    dev = logprob.device
    stay_idx, move_idx = make_seq_indices(seqs, nbase)
    # mod column of each entered position p >= 1
    mod_seq = (torch.as_tensor(offsets, dtype=torch.long, device=dev)[
        torch.remainder(seqs[:, 1:], nbase).long()] + mod_cats[:, 1:].long())
    modmove_idx = (n_can_trans + mod_seq).int()
    modmove_fact = torch.as_tensor(np.asarray(mod_cat_weights),
                                   dtype=torch.float32, device=dev)[mod_seq]
    trans_sharp = torch.where(torch.arange(ntrans, device=dev) < n_can_trans,
                              float(sharpfact), 1.0)
    lp32 = logprob.float()
    lp = lp32 + (lp32 * trans_sharp - lp32).detach()
    core = _CrfLossCore.apply(lp, stay_idx, move_idx, modmove_idx,
                              modmove_fact, seqlens)
    return core + (core / sharpfact - core).detach()


class _LogZ(torch.autograd.Function):
    """logZ [B] of scores [T, B, S]; its gradient is the posterior over
    the transitions times the incoming gradient."""

    @staticmethod
    def forward(ctx, scores):
        nbase = flipflopfings.nbase_flipflop(scores.shape[2])
        _, logz, lattice = logz_fwd(scores,
                                    emit_lattice=ctx.needs_input_grad[0])
        ctx.save_for_backward(scores, lattice)
        return logz + math.log(nbase)

    @staticmethod
    def backward(ctx, g):
        scores, lattice = ctx.saved_tensors
        return logz_posteriors(scores, lattice) * g[None, :, None]


def flipflop_logz(scores):
    """Log partition function of the flip-flop transition lattice.

    Args:
        scores: [nblk, batch, nstate] f32 transition weights.

    Returns:
        [batch] f32 log partition values.
    """
    return _LogZ.apply(scores.contiguous())
