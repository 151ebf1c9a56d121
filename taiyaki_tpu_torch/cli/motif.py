"""Log-odds of base abundance around given coordinates, to find a motif
(port of misc/motif.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.motif [options] references.fa coordinates.tsv

For each row of the coordinates TSV (columns filename, pos) naming a
reference of the fasta, the bases from pos - down to pos + up; prints,
for each offset from -down to up, the log of each base's frequency
there (A, C, G, T) over its background frequency: that of the fragments
themselves, or with --refbackground that of the whole fasta.  Prints
"No reads" where no row gives a fragment.
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.bio import fasta_file_to_dict
from taiyaki_tpu_torch.utils.cmdargs import AutoBool, FileExists, Positive
from taiyaki_tpu_torch.utils.fileio import readtsv

BASES = {b: i for i, b in enumerate("ACGT")}


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--refbackground", default=False, action=AutoBool,
                        help="Estimate base background frequencies from the fasta")
    parser.add_argument("--down", metavar="bases", type=Positive(int),
                        default=15, help="bases to keep downstream of the site")
    parser.add_argument("--up", metavar="bases", type=Positive(int),
                        default=15, help="bases to keep upstream of the site")
    parser.add_argument("references", action=FileExists,
                        help="Reference fasta to scan")
    parser.add_argument("coordinates", action=FileExists,
                        help="coordinates file (columns filename, pos)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    up = args.up + 1
    refdict = fasta_file_to_dict(args.references)
    coordinates = readtsv(args.coordinates)

    background_counts = np.zeros(len(BASES), dtype=float)
    if args.refbackground:
        for ref in refdict.values():
            background_counts += [ref.count(b) for b in BASES]

    frags = []
    for coord in coordinates:
        readname, pos = str(coord["filename"]), int(coord["pos"])
        if pos < args.down or readname not in refdict:
            continue
        ref = refdict[readname]
        if pos + up > len(ref):
            continue
        frag = ref[pos - args.down:pos + up]
        frags.append(np.array([BASES[b] for b in frag]))
    if not frags:
        print("No reads")
        return 0

    frag_array = np.stack(frags).T
    count_array = []
    for pos_array in frag_array:
        counts = np.bincount(pos_array, minlength=len(BASES))
        count_array.append(counts)
        if not args.refbackground:
            background_counts += counts
    background_counts /= background_counts.sum()
    position_counts = np.stack(count_array) / len(frags)
    log_odds = np.log(position_counts / background_counts)
    for pos, row in zip(range(-args.down, up), log_odds):
        print(pos, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
