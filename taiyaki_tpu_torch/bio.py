"""Sequence string utilities (reference: taiyaki/bio.py).

fasta parsing is self-contained (no Biopython dependency).
"""

import re
import sys

from taiyaki_tpu_torch.constants import DEFAULT_ALPHABET

_COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C", "X": "X", "N": "N",
               "a": "t", "t": "a", "c": "g", "g": "c", "x": "x", "n": "n",
               "-": "-"}


def complement(seq, compdict=_COMPLEMENT):
    """Complement of a base sequence."""
    return "".join(compdict[b] for b in seq)


def reverse_complement(seq, compdict=_COMPLEMENT):
    """Reverse complement of a base sequence."""
    return complement(seq, compdict)[::-1]


def iter_fasta(fh):
    """Yield (name, sequence) records from an open fasta file handle.

    Empty-sequence and empty-name records are preserved — SeqIO (which
    the reference parses with) yields them, and dropping one desyncs
    index-keyed reference dicts (train_abinitio)."""
    name = None
    parts = []
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(parts)
            fields = line[1:].split()
            name = fields[0] if fields else ""
            parts = []
        else:
            parts.append(line)
    if name is not None:
        yield name, "".join(parts)


def fasta_file_to_dict(fasta_file_name, filter_ambig=True, flatten_ambig=True,
                       alphabet=DEFAULT_ALPHABET):
    """Load fasta records into {id: sequence}.

    Args:
        filter_ambig: drop sequences containing characters outside alphabet.
        flatten_ambig: replace such characters with N.
    """
    notbase = re.compile("[^{}]".format(alphabet))
    references = {}
    n_ambig = 0
    with open(fasta_file_name) as fh:
        for name, seq in iter_fasta(fh):
            if len(seq) == 0:
                continue
            if filter_ambig and notbase.search(seq) is not None:
                n_ambig += 1
                continue
            if flatten_ambig:
                seq = notbase.sub("N", seq)
            references[name] = seq
    if n_ambig > 0:
        sys.stderr.write(
            "* {} reference sequences contain ambiguous bases not found in "
            "the provided alphabet and will be skipped.".format(n_ambig))
    return references
