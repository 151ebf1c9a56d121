"""Flip-flop decoding (port of taiyaki_tpu/ops/decode.py): Viterbi best
path, posterior transition probabilities, global normalisation.

`flipflop_viterbi` is plain PyTorch, as it is a `lax.scan` and not a
kernel in the JAX package; `flipflop_make_trans` runs the logZ forward
and posterior kernels of `ops.logz`, in the instance that the switches
pick (`ops.flipflop.logz_lattice`), as the JAX package takes its
posteriors through `_logz_pallas`'s vjp.
"""

import torch

from taiyaki_tpu_torch import flipflopfings
from taiyaki_tpu_torch.constants import LARGE_VAL
from taiyaki_tpu_torch.ops.flipflop import flipflop_logz, logz_lattice, \
    logz_post


def flipflop_viterbi(scores):
    """Highest-scoring flip-flop path per batch element.  Ties go to the
    first maximum, as jnp.argmax breaks them.

    Args:
        scores: [T, batch, nstate] log-scale transition scores
            (nstate = 2*nbase*(nbase+1)).

    Returns:
        (fwd [T+1, batch, 2*nbase], traceback [T, batch, 2*nbase] int32,
         path [T+1, batch] int32).
    """
    T, N, S = scores.shape
    nbase = flipflopfings.nbase_flipflop(S)
    nff = 2 * nbase
    dev = scores.device
    fwd = torch.cat([torch.zeros(N, nbase, dtype=scores.dtype, device=dev),
                     torch.full((N, nbase), -LARGE_VAL, dtype=scores.dtype,
                                device=dev)], dim=1)
    base_ids = torch.arange(nbase, device=dev)
    fwds = [fwd]
    tbs = []
    for t in range(T):
        cand_flip = fwd[:, None, :] + scores[t, :, :S - nff].view(N, nbase,
                                                                  nff)
        cand_flop = (fwd + scores[t, :, S - nff:]).view(N, 2, nbase)
        fwd = torch.cat([cand_flip.amax(dim=2), cand_flop.amax(dim=1)], dim=1)
        tbs.append(torch.cat([cand_flip.argmax(dim=2),
                              cand_flop.argmax(dim=1) * nbase + base_ids],
                             dim=1))
        fwds.append(fwd)
    traceback = (torch.stack(tbs) if tbs
                 else torch.zeros(0, N, nff, dtype=torch.int64, device=dev))

    path = torch.empty(T + 1, N, dtype=torch.int64, device=dev)
    path[T] = fwd.argmax(dim=1)
    for t in range(T - 1, -1, -1):
        path[t] = traceback[t].gather(1, path[t + 1][:, None])[:, 0]
    return (torch.stack(fwds), traceback.to(torch.int32),
            path.to(torch.int32))


def flipflop_make_trans(scores):
    """Posterior transition probabilities (NOT logs), d logZ / d scores.

    Args:
        scores: [T, batch, nstate] globally-normalisable transition scores.

    Returns:
        [T, batch, nstate] f32 posterior probabilities (under
        TAIYAKI_TPU_BF16_STREAMS=1 bf16 ones widened).
    """
    scores, _, lattice = logz_lattice(scores.to(torch.float32))
    return logz_post(scores, lattice).float()


def global_norm_flipflop(scores):
    """Globally normalise scores so the partition function is 1."""
    T = scores.shape[0]
    logz = flipflop_logz(scores)
    return scores - (logz / T)[None, :, None]
