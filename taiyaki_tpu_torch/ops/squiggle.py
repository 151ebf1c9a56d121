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
(`decodeutil.squiggle_viterbi`), or the JAX package's numpy loop under
TAIYAKI_TPU_NO_NATIVE=1 (for a host without g++); a failed build raises.
"""

import math
import os

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

    The recursion runs in f64 (the emissions, penalties and states; the
    costs and the gradient into f32 params are rounded to f32 at the
    end).  In f32 it was too short: over up to 4352 samples the states
    reach thousands in log space, where an f32 ulp is ~5e-4, and every
    logaddexp's weight exp(a - result) carries that rounding into the
    gradient (1.2e-4 of its largest against the recursion in f64 at 2000
    samples, tests/test_torch_squiggle.py).  Shifting each sample's
    states by their maximum keeps them near 0, but not the states far
    below it that later carry the path, whose rounding still walks over
    the samples; each device rounds exp and log1p its own way, so the
    card and the CPU drift apart by as much (chip_smoke.py's phase 13a
    compares them).  The loop is bound by its launches, not its
    arithmetic: f64 costs the card little time and doubles what autograd
    keeps.
    """
    dev = params.device
    params = params.double()
    signals = torch.as_tensor(signals, dtype=torch.float32,
                              device=dev).double()
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
    fwd = torch.full((nbatch, 2 * npos), -_LARGE, dtype=torch.float64,
                     device=dev)
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
    return -fwd[:, npos - 1].float()


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

    The C++ decoder unless TAIYAKI_TPU_NO_NATIVE=1, which takes the numpy
    loop below (the JAX package's).  A failed build raises; it never falls
    back to the loop unasked.
    """
    localpen = LARGE_LOG_VAL if localpen is None else localpen
    minscore = LARGE_LOG_VAL if minscore is None else minscore
    if os.environ.get("TAIYAKI_TPU_NO_NATIVE") != "1":
        return decodeutil.squiggle_viterbi(params, signal, back_prob,
                                           localpen, minscore)
    params = np.asarray(params, dtype=np.float32)
    signal = np.asarray(signal, dtype=np.float32)
    npos = len(params)
    nsample = len(signal)
    nfstate = npos + 2                 # start + positions + end
    nstate = nfstate + npos            # + backward states

    loc, logscale, rate = params[:, 0], params[:, 1], params[:, 2]
    scale = np.exp(logscale)
    move_p = (1.0 - back_prob) * (0.5 * (1.0 + np.tanh(rate / 2.0)))
    move_pen = np.empty(nfstate, dtype=np.float64)
    stay_pen = np.empty(nfstate, dtype=np.float64)
    move_pen[1:npos + 1] = np.log(move_p)
    stay_pen[1:npos + 1] = np.log1p(-move_p - back_prob)
    move_pen[0] = move_pen[npos + 1] = move_pen[1:npos + 1].mean()
    stay_pen[0] = stay_pen[npos + 1] = stay_pen[1:npos + 1].mean()
    move_back_pen = np.log(back_prob)
    half = np.log(0.5)

    fwd = np.full(nstate, -_LARGE)
    fwd[0] = 0.0
    traceback = np.zeros((nsample, nstate), dtype=np.int32)

    for t in range(nsample):
        prev = fwd
        curr = prev + np.concatenate([stay_pen, np.full(npos, half)])
        tb = np.arange(nstate, dtype=np.int32)
        # move to next full state
        cand = prev[:nfstate - 1] + move_pen[:nfstate - 1]
        better = cand > curr[1:nfstate]
        curr[1:nfstate] = np.where(better, cand, curr[1:nfstate])
        tb[1:nfstate] = np.where(better, np.arange(nfstate - 1), tb[1:nfstate])
        # start -> any position (local clipping of head), vectorized over
        # destination positions 1..npos-1 (states 2..npos)
        head = prev[0] + move_pen[0] - localpen * np.arange(1, npos)
        better = head > curr[2:npos + 1]
        curr[2:npos + 1] = np.where(better, head, curr[2:npos + 1])
        tb[2:npos + 1] = np.where(better, 0, tb[2:npos + 1])
        # any position -> end (local clipping of tail): only the best
        # origin can win; argmax returns the FIRST maximum, matching the
        # sequential loop's strict-improvement tie-break
        origst = np.arange(1, npos)
        tail = (prev[origst] + move_pen[origst]
                - localpen * (npos - origst))
        if len(tail):   # npos == 1: no tail origins (C++ guards npos > 1)
            k = int(np.argmax(tail))
            if tail[k] > curr[nfstate - 1]:
                curr[nfstate - 1] = tail[k]
                tb[nfstate - 1] = origst[k]
        # position p+1 -> back state p
        cand = prev[2:npos + 1] + move_back_pen
        idx = nfstate + np.arange(npos - 1)
        better = cand > curr[idx]
        curr[idx] = np.where(better, cand, curr[idx])
        tb[idx] = np.where(better, np.arange(2, npos + 1), tb[idx])
        # back state p -> position p+1
        cand = prev[nfstate:nfstate + npos - 1] + half
        better = cand > curr[2:npos + 1]
        curr[2:npos + 1] = np.where(better, cand, curr[2:npos + 1])
        tb[2:npos + 1] = np.where(
            better, nfstate + np.arange(npos - 1), tb[2:npos + 1])
        # emissions
        logscore = np.maximum(
            -minscore,
            -np.abs(signal[t] - loc) / scale - logscale - np.log(2.0))
        curr[1:npos + 1] += logscore
        curr[nfstate:] += logscore
        curr[0] -= localpen
        curr[nfstate - 1] -= localpen
        traceback[t] = tb
        fwd = curr

    path = np.zeros(nsample, dtype=np.int32)
    if fwd[nfstate - 2] > fwd[nfstate - 1]:
        score, path[-1] = fwd[nfstate - 2], nfstate - 2
    else:
        score, path[-1] = fwd[nfstate - 1], nfstate - 1
    for t in range(nsample - 1, 0, -1):
        path[t - 1] = traceback[t, path[t]]

    # encode start/end as -1; full states offset by 1; back states by nfstate
    out = path.copy()
    lo = 0
    while lo < nsample and out[lo] == 0:
        out[lo] = -1
        lo += 1
    hi = nsample
    while hi > 0 and out[hi - 1] == nfstate - 1:
        out[hi - 1] = -1
        hi -= 1
    mid = out[lo:hi]
    mid = np.where(mid >= nfstate, mid - nfstate, mid - 1)
    out[lo:hi] = mid
    return float(score), out
