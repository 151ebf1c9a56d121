"""Estimate per-read trim/shift/scale parameters into a TSV (port of
bin/generate_per_read_params.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.generate_per_read_params \
        [--output readparams.tsv] reads/
"""

import argparse
import csv
import sys

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import NonNegative
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args
from taiyaki_tpu_torch.data import fast5utils
from taiyaki_tpu_torch.data.signal import Signal
from taiyaki_tpu_torch.iterators import imap_mp
from taiyaki_tpu_torch.maths import med_mad
from taiyaki_tpu_torch.utils.helpers import open_file_or_stdout


def get_parser():
    parser = argparse.ArgumentParser()
    add_common_command_args(
        parser, ("input_folder input_strand_list limit output recursive "
                 "version jobs").split())
    parser.add_argument(
        "--trim", default=(200, 50), nargs=2, type=NonNegative(int),
        metavar=("beginning", "end"),
        help="Samples to discard at the read start and end")
    return parser


def one_read_shift_scale(read_tuple):
    """Median/MAD scaling parameters for one read; (None, None, None) on
    failure, NaNs for empty signals."""
    read_filename, read_id = read_tuple
    try:
        with fast5utils.get_fast5_file(read_filename) as f5:
            sig = Signal(f5.get_read(read_id))
    except Exception as e:
        sys.stderr.write(
            "Unable to obtain signal for {} from {}.\n{}\n".format(
                read_id, read_filename, repr(e)))
        return None, None, None
    current = sig.current
    if len(current) > 0:
        shift, scale = med_mad(current)
    else:
        shift = scale = np.nan
    return read_id, shift, scale


def main(argv=None):
    args = get_parser().parse_args(argv)
    trim_start, trim_end = args.trim
    fast5_reads = fast5utils.iterate_fast5_reads(
        args.input_folder, limit=args.limit,
        strand_list=args.input_strand_list, recursive=args.recursive)
    with open_file_or_stdout(args.output) as tsvfile:
        writer = csv.writer(tsvfile, delimiter="\t", lineterminator="\n")
        writer.writerow(["UUID", "trim_start", "trim_end", "shift", "scale"])
        for result in imap_mp(one_read_shift_scale, fast5_reads,
                              threads=args.jobs):
            if all(r is not None for r in result):
                read_id, shift, scale = result
                writer.writerow([read_id, trim_start, trim_end, shift,
                                 scale])


if __name__ == "__main__":
    main()
