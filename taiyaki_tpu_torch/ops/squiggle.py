"""Squiggle match: align observed current to a predicted squiggle (port of
taiyaki_tpu/ops/squiggle.py).

Model: 2*npos states, each sequence position and a "backward" shadow
state entered with probability back_prob.  Emissions are Laplace(level,
exp(log scale)) with per-position parameters; the move probability is
(1 - back_prob) * logistic(rate).  The training cost is the negative
forward log-probability of the signal, a recursion over samples in plain
PyTorch ops on the parameters' device; autograd runs through it, as the
JAX package differentiates its `lax.scan` (the JAX package has no Pallas
kernel here).  The emissions of every sample are formed in one batch of
ops before the recursion, which then runs a few small ops a sample.

The glocal Viterbi path that map_to_squiggle takes is host C++
(`decodeutil.squiggle_viterbi`); a failed build raises.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from taiyaki_tpu_torch import decodeutil
from taiyaki_tpu_torch.constants import DEFAULT_ALPHABET, LARGE_LOG_VAL

_LARGE = 1e30

# Vertices of a regular tetrahedron: the base embedding for squiggle
# prediction.
CARTESIAN_TETRAHEDRON = np.array(
    [[1.0, 0.0, -1.0 / np.sqrt(2.0)],
     [-1.0, 0.0, -1.0 / np.sqrt(2.0)],
     [0.0, 1.0, 1.0 / np.sqrt(2.0)],
     [0.0, -1.0, 1.0 / np.sqrt(2.0)]], dtype=np.float32)


def embed_sequence(seq, alphabet=DEFAULT_ALPHABET):
    """Embed a base sequence at tetrahedron vertices -> [len, 3] float32.

    seq may be a string over `alphabet` or an integer label array
    (alphabet=None).
    """
    if alphabet is None:
        idx = np.asarray(seq, dtype=np.int64)
    else:
        lut = {b: i for i, b in enumerate(alphabet)}
        idx = np.array([lut[b] for b in seq])
    return CARTESIAN_TETRAHEDRON[idx]


def squiggle_match_cost(params, signals, siglens, back_prob):
    """Negative forward log-probabilities of signals under predicted
    squiggles.

    Args:
        params: [npos, batch, 3] f32 tensor of predicted (level, log scale,
            rate).
        signals: [maxlen, batch] observed currents, padded.
        siglens: [batch] true signal lengths.
        back_prob: probability of entering the backward state.

    Returns:
        [batch] f32 costs (-forward score) on params' device.
    """
    dev = params.device
    params = params.float()
    signals = torch.as_tensor(signals, dtype=torch.float32, device=dev)
    siglens = torch.as_tensor(siglens, device=dev)
    npos, nbatch, _ = params.shape
    nsample = signals.shape[0]

    loc = params[:, :, 0].t()                       # [batch, npos]
    logscale = params[:, :, 1].t()
    scale = torch.exp(logscale)
    # log_sigmoid penalties: log1p(-(1-b)*sigmoid(r) - b) rounds to log(0)
    # once sigmoid(r) is 1.0 in f32 (r >= ~17), and its gradient is then
    # NaN for every parameter; (1-b)*(1-sigmoid(r)) is the same value
    rate = params[:, :, 2].t()
    log_no_back = float(np.log1p(np.float32(-back_prob)))
    move_pen = log_no_back + F.logsigmoid(rate)
    stay_pen = log_no_back + F.logsigmoid(-rate)
    move_back_pen = float(np.log(np.float32(back_prob)))
    half = math.log(0.5)

    # Laplace emissions of every sample at every state, [batch, 2*npos] a
    # sample (a backward state emits as its position), and which samples
    # lie within their signal; unbound, so that the backward pass stacks
    # the samples' gradients once instead of each step's into a [T, ...]
    # tensor of zeros
    logscore = (-torch.abs(signals[:, :, None] - loc) / scale - logscale
                - math.log(2.0))
    logscore = torch.cat([logscore, logscore], dim=2).unbind(0)
    active = (torch.arange(nsample, device=dev)[:, None]
              < siglens[None, :])[:, :, None].unbind(0)
    # staying: in a position, and in a backward state (probability 1/2)
    stay = torch.cat([stay_pen, torch.full_like(stay_pen, half)], dim=1)
    move_pen = move_pen[:, 1:]

    # state [batch, 2*npos] = [positions | backward states]; at position 0
    fwd = torch.full((nbatch, 2 * npos), -_LARGE, device=dev)
    fwd[:, 0] = 0.0
    for t in range(nsample):
        stayed = fwd + stay
        normal = fwd[:, :npos]
        # position p: stay; move on from p - 1; return from backward
        # state p - 1
        moved = torch.logaddexp(torch.logaddexp(
            stayed[:, 1:npos], normal[:, :-1] + move_pen),
            stayed[:, npos:-1])
        # backward state p: stay; enter from position p + 1
        entered = torch.logaddexp(stayed[:, npos:-1],
                                  normal[:, 1:] + move_back_pen)
        new = torch.cat([stayed[:, :1], moved, entered, stayed[:, -1:]],
                        dim=1) + logscore[t]
        # finished signals keep their state
        fwd = torch.where(active[t], new, fwd)
    return -fwd[:, npos - 1]


squiggle_match_loss = squiggle_match_cost


def squiggle_match_viterbi_path(params, signal, back_prob, localpen=None,
                                minscore=None):
    """Best glocal alignment path of one signal to a predicted squiggle
    (host C++, `decodeutil.squiggle_viterbi`).

    Args:
        params: [npos, 3] squiggle parameters.
        signal: [nsample] observed current.
        back_prob: probability of a backward move.
        localpen: per-sample cost of sitting in the start/end states (None:
            a global alignment).
        minscore: floor on per-sample emission scores (None: no floor).

    Returns:
        (score, path [nsample]): path entries are sequence positions, -1
        in the clipped head and tail.
    """
    localpen = LARGE_LOG_VAL if localpen is None else localpen
    minscore = LARGE_LOG_VAL if minscore is None else minscore
    return decodeutil.squiggle_viterbi(params, signal, back_prob, localpen,
                                       minscore)
