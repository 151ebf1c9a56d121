"""Split a strand list into parts (port of misc/split_strandlist.py; host
only, no device).

    python -m taiyaki_tpu_torch.cli.split_strandlist [--nparts N] [--prefix P] strands.tsv

Writes <prefix>_part<i>.tsv for i < N, each with the header row and its
share of the lines in order (ceil(lines / N) a part, the last ones
shorter or empty), and names each on stderr.
"""

import argparse
import sys


def get_parser():
    parser = argparse.ArgumentParser(
        description="Split a strand list into parts",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--nparts", type=int, default=2,
                        help="Number of parts to split into")
    parser.add_argument("--prefix", default=None,
                        help="Output prefix (default: input filename)")
    parser.add_argument("strandlist", help="Input strand list TSV")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    with open(args.strandlist) as fh:
        header = fh.readline()
        lines = fh.readlines()
    prefix = args.prefix or args.strandlist
    per = -(-len(lines) // args.nparts)
    for part in range(args.nparts):
        out = "{}_part{}.tsv".format(prefix, part)
        with open(out, "w") as fh:
            fh.write(header)
            fh.writelines(lines[part * per:(part + 1) * per])
        sys.stderr.write("Wrote {}\n".format(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
