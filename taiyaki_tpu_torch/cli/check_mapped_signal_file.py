"""Check the integrity of a mapped-signal file and print a summary (port
of misc/check_mapped_signal_file.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.check_mapped_signal_file [options] mapped.hdf5

Prints the file's version, alphabet and read count, the verdict of
`MappedSignalReader.check`, and the median dwell and reference length of
the first --summary_limit reads.  Exits 0 when the check passes, else 1,
as the JAX tool does.  The file is read through h5py where it is
installed, else through the port's data/hdf5.py.
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.data.mapped_signal_files import MappedSignalReader
from taiyaki_tpu_torch.utils.cmdargs import FileExists, Maybe, Positive


def get_parser():
    parser = argparse.ArgumentParser(
        description="Check a mapped signal file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "--limit_report_lines", default=100, type=Positive(int),
        help="Maximum number of error lines to report")
    parser.add_argument(
        "--summary_limit", default=10, type=Maybe(Positive(int)),
        help="Number of reads to summarize (None for all)")
    parser.add_argument("input", action=FileExists,
                        help="Mapped signal file")
    return parser


def main(argv=None):
    """Check the file; returns the exit code (0 if the check passes)."""
    args = get_parser().parse_args(argv)
    with MappedSignalReader(args.input) as msr:
        print("* File version:", msr.version)
        ai = msr.get_alphabet_information()
        print("* Alphabet: {} (collapse: {})".format(
            ai.alphabet, ai.collapse_alphabet))
        if ai.nmod_base > 0:
            print("* Modified bases:", ai.mod_long_names)
        read_ids = msr.get_read_ids()
        print("* {} reads".format(len(read_ids)))
        verdict = msr.check(args.limit_report_lines)
        print("* Integrity check:", verdict.strip())
        dwells, lens = [], []
        for i, read in enumerate(msr.reads()):
            if args.summary_limit is not None and i >= args.summary_limit:
                break
            d0, d1 = read.get_mapped_dacs_region()
            r0, r1 = read.get_mapped_reference_region()
            if r1 > r0:
                dwells.append((d1 - d0) / (r1 - r0))
            lens.append(read.reflen)
        if dwells:
            print("* Mean dwell over sampled reads: median {:.2f} "
                  "(range {:.2f}-{:.2f})".format(
                      float(np.median(dwells)), min(dwells), max(dwells)))
        if lens:  # independent of dwell: print even if nothing mapped
            print("* Reference lengths: median {:.0f} "
                  "(range {}-{})".format(
                      float(np.median(lens)), min(lens), max(lens)))
    return 0 if verdict.strip() == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
