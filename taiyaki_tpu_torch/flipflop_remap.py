"""Glocal Viterbi remapping: align flip-flop transition scores to a known
sequence (port of taiyaki_tpu/flipflop_remap.py, on the port's C++
`decodeutil.remap_viterbi`, or on the JAX package's numpy loop under
TAIYAKI_TPU_NO_NATIVE_REMAP=1, for a host without g++).

The lattice has one column per sequence position plus "start"/"end"
states; staying in start/end costs `localpen` per block, so localpen =
LARGE_VAL forces global alignment and smaller values permit clipping
("glocal").  Blocks spent in start/end are marked -1 in the returned path.
"""

import os

import numpy as np

from taiyaki_tpu_torch import decodeutil, flipflopfings
from taiyaki_tpu_torch.constants import DEFAULT_ALPHABET, LARGE_VAL


def map_to_crf_viterbi(scores, step_index, stay_index, localpen=LARGE_VAL):
    """Best path through the (blocks x sequence-positions) lattice.

    Args:
        scores: [T, nstate] log-space transition scores (host, float32).
        step_index: [M-1] score columns for moving to the next position.
        stay_index: [M] score columns for staying at each position.
        localpen: per-block cost of sitting in the start/end state.

    Returns:
        (best score, path [T+1] of sequence positions, -1 in start/end).

    The C++ decoder unless TAIYAKI_TPU_NO_NATIVE_REMAP=1, which takes the
    numpy loop below (the JAX package's; the same path, the score to f32
    rounding, as its start and end states are f32 and the C++'s f64).  A
    failed build raises; it never falls back to the loop unasked.
    """
    if os.environ.get("TAIYAKI_TPU_NO_NATIVE_REMAP") != "1":
        return decodeutil.remap_viterbi(scores, stay_index, step_index,
                                        localpen)
    T = len(scores)
    M = len(stay_index)
    if len(step_index) != M - 1:
        raise ValueError("step_index has {} entries for {} positions"
                         .format(len(step_index), M))

    # Viterbi scores for the current/previous block boundary
    curr = np.full(M, -LARGE_VAL)
    curr[0] = 0.0
    start_score = 0.0
    end_score = -LARGE_VAL
    alignment_end = 0

    # traceback: bit m of row t+1 says position m was entered by a step
    # (from m-1) rather than a stay; bit-packed, T*M/8 bytes
    traceback = np.zeros((T + 1, (M + 7) // 8), dtype=np.uint8)
    tb_row = np.zeros(M, dtype=np.uint8)

    for t in range(T):
        stay_sc = scores[t, stay_index]
        step_sc = scores[t, step_index]

        prev = curr
        stayed = prev + stay_sc
        stepped = prev[:-1] + step_sc

        # the start state accrues the better of position 0's stay score
        # and the local penalty; leaving it into position 0 pays localpen
        leave_start = start_score - localpen
        start_score = start_score + max(stay_sc[0], -localpen)

        curr = stayed.copy()
        better_step = stepped > stayed[1:]
        curr[1:] = np.where(better_step, stepped, stayed[1:])
        tb_row[:] = 0
        tb_row[1:] = better_step
        if start_score > curr[0]:
            curr[0] = start_score
        tb_row[0] = 1 if leave_start > stayed[0] else 0
        traceback[t + 1] = np.packbits(tb_row)

        # the end state: keep sitting in it, or step in from the previous
        # boundary's final sequence position
        remain_end = end_score + max(stay_sc[-1], -localpen)
        step_end = prev[-1] - localpen
        if step_end > remain_end:
            end_score = step_end
            alignment_end = t
        else:
            end_score = remain_end

    path = np.full(T + 1, -1, dtype=int)
    if curr[-1] > end_score:
        t, m = T, M - 1
    else:
        t, m = alignment_end, M - 1
    while t >= 0 and m >= 0:
        path[t] = m
        move = (traceback[t, m >> 3] >> (7 - (m & 7))) & 1
        m -= int(move)
        t -= 1
    return float(max(curr[-1], end_score)), path


def flipflop_remap(transition_scores, sequence, alphabet=DEFAULT_ALPHABET,
                   localpen=LARGE_VAL):
    """Align flip-flop transition scores [T, nstate] to a known sequence.

    Builds the stay/step score columns of the flip-flop-coded sequence and
    runs the glocal Viterbi.

    Returns:
        (score, path [T+1]): path[t] is the sequence position occupied at
        block boundary t; -1 where the alignment sits in start/end.
    """
    nbase = len(alphabet)
    # .find as in the JAX package: a base outside the alphabet is -1, and
    # its columns wrap as numpy indexing wraps them (below)
    bases = np.array([alphabet.find(b) for b in sequence])
    flops = flipflopfings.flopmask(bases)

    # stay columns: flip b stays at b*(2*nbase)+b; flop stays in the final
    # block at (2*nbase+1)*nbase + b
    stay_index = np.where(flops, bases + (2 * nbase + 1) * nbase,
                          bases + 2 * nbase * bases)
    from_state = (bases + flops * nbase)[:-1]
    to_block = np.maximum(bases, nbase * flops)[1:]
    step_index = from_state + 2 * nbase * to_block

    nstate = np.shape(transition_scores)[1]
    return map_to_crf_viterbi(transition_scores, step_index % nstate,
                              stay_index % nstate, localpen=localpen)
