"""Flip-flop CRF loss and partition function (port of
taiyaki_tpu/ops/flipflop.py).

`crf_flipflop_loss` runs the CRF lattice kernels of `ops.crf` (the forward
in the forward pass, the backward in the backward pass) and
`flipflop_logz` the logZ kernels of `ops.logz` (forward and posteriors),
each as a `torch.autograd.Function`.  Values follow the JAX package's CPU
scan: the loss is -score/nblk, zero for an empty row; logZ counts the
initial logsumexp of the start vector, log(nbase), which the forward
kernel leaves out and this module adds back.
"""

import math

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


class _CrfLossCore(torch.autograd.Function):
    """cost [B] of (sharpened) scores lp [T, B, S]; the gradient is
    -posterior/nblk, zeroed for rows with seqlens == 0."""

    @staticmethod
    def forward(ctx, lp, stay_idx, move_idx, seqlens):
        nblk = lp.shape[0]
        lp = lp.contiguous()
        idx = _lattice_inputs(stay_idx, move_idx, seqlens, lp.shape[2])
        sidx, midx, mmidx, mfact, valid, last = idx
        fwd, score, lattice = crf.crf_fwd(lp, sidx, midx, mmidx, mfact,
                                          valid,
                                          emit_lattice=ctx.needs_input_grad[0])
        score = score + fwd.gather(1, last.long()[:, None])[:, 0]
        ctx.save_for_backward(lp, lattice, seqlens, *idx)
        return _masked_cost(score, seqlens, nblk)

    @staticmethod
    def backward(ctx, g):
        lp, lattice, seqlens, sidx, midx, mmidx, mfact, valid, last = \
            ctx.saved_tensors
        post = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lattice, valid,
                           last)
        gm = torch.where(seqlens > 0, g, torch.zeros_like(g))
        return (-post / lp.shape[0]) * gm[None, :, None], None, None, None


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
    return _CrfLossCore.apply(lp, stay_idx, move_idx, seqlens) / sharpfact


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
