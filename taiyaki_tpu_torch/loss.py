"""Reference losses in plain PyTorch (port of taiyaki_tpu/loss.py).

Loops over time, differentiated by autograd: readable specifications and
cross-checks for the kernels' loss in ops/flipflop.py.  No CLI calls them.
"""

import torch

_NEG = -1e30


def _forward(x, first, sharp, stay_score, move_score):
    """The forward recursion over x's blocks from the state `first`
    [batch, npos] f32: at each block, stay at a position or move on from
    the one before, with the scores stay_score(xt) [batch, npos] and
    move_score(xt) [batch, npos - 1] of the sharpened block xt."""
    fwd = first
    for xt in x * sharp:
        score = stay_score(xt) + fwd
        move = move_score(xt) + fwd[:, :-1]
        fwd = torch.cat([score[:, :1],
                         torch.logaddexp(move, score[:, 1:])], dim=1)
    return fwd


def _start(x, npos):
    fwd = torch.full((x.shape[1], npos), _NEG, dtype=torch.float32,
                     device=x.device)
    fwd[:, 0] = 0.0
    return fwd


def ctc_loss(x, seqs, seqlens, sharp=1.0):
    """Negative log-likelihood under a 5-feature CTC model.

    Args:
        x: [T, batch, 5] scores: features 0-3 the bases, feature 4 the stay.
        seqs: [batch, npos] base indices (0-3), padded.
        seqlens: [batch] sequence lengths.
        sharp: sharpening factor.

    Returns:
        [batch] costs = -fwd[seqlen] / (T * sharp).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    nt, _, nf = x.shape
    if nf != 5:
        raise ValueError("CTC requires 5 features, got {}".format(nf))
    seqs = torch.as_tensor(seqs, dtype=torch.int64, device=x.device)
    seqlens = torch.as_tensor(seqlens, dtype=torch.int64, device=x.device)
    fwd = _forward(x, _start(x, seqs.shape[1] + 1), sharp,
                   lambda xt: xt[:, 4:5],
                   lambda xt: torch.gather(xt, 1, seqs))
    final = torch.gather(fwd, 1, seqlens[:, None])[:, 0]
    return -final / (nt * sharp)


def flipflop_loss(x, move_idx, stay_idx, seqlens, sharp=1.0):
    """Negative log-likelihood under the flip-flop CRF (numerator only).

    Args:
        x: [T, batch, 40] transition scores.
        move_idx: [batch, npos-1] move transition columns.
        stay_idx: [batch, npos] stay transition columns.
        seqlens: [batch] sequence lengths.
        sharp: sharpening factor.

    Returns:
        [batch] costs = -fwd[seqlen - 1] / (T * sharp).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    nt = x.shape[0]
    move_idx = torch.as_tensor(move_idx, dtype=torch.int64, device=x.device)
    stay_idx = torch.as_tensor(stay_idx, dtype=torch.int64, device=x.device)
    seqlens = torch.as_tensor(seqlens, dtype=torch.int64, device=x.device)
    npos = stay_idx.shape[1]
    if move_idx.shape[1] != npos - 1:
        raise ValueError("move_idx has {} columns for {} positions".format(
            move_idx.shape[1], npos))
    fwd = _forward(x, _start(x, npos), sharp,
                   lambda xt: torch.gather(xt, 1, stay_idx),
                   lambda xt: torch.gather(xt, 1, move_idx))
    final = torch.gather(fwd, 1, seqlens[:, None] - 1)[:, 0]
    return -final / (nt * sharp)
