"""Glocal Viterbi remapping: align flip-flop transition scores to a known
sequence (port of taiyaki_tpu/flipflop_remap.py, on the port's C++
`decodeutil.remap_viterbi`).

The lattice has one column per sequence position plus "start"/"end"
states; staying in start/end costs `localpen` per block, so localpen =
LARGE_VAL forces global alignment and smaller values permit clipping
("glocal").  Blocks spent in start/end are marked -1 in the returned path.
"""

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
    """
    return decodeutil.remap_viterbi(scores, stay_index, step_index,
                                    localpen)


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
