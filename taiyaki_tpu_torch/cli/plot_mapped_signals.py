"""Plot reference-to-signal maps of mapped-signal files, and print a
one-line summary of each read (port of misc/plot_mapped_signals.py; host
only, no device).

    python -m taiyaki_tpu_torch.cli.plot_mapped_signals [options] mapped.hdf5 [...]

For the first --nreads reads of each file, or the --read_ids given (in
their order; an absent one is named on stderr), each mapped read's
summary (file, index, read id, reference and signal lengths) goes to
stdout and, with --output, its Ref_to_signal to the plot.  Without
--output only the summaries are printed; with it, where matplotlib is
not installed, exits non-zero naming it before reading anything.  The
files are read through h5py where it is installed, else through the
port's data/hdf5.py.
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.data.mapped_signal_files import MappedSignalReader
from taiyaki_tpu_torch.utils.cmdargs import Positive
from taiyaki_tpu_torch.utils.plotting import require_pyplot


def get_parser():
    parser = argparse.ArgumentParser(
        description="Plot reference-to-signal maps from mapped signal "
                    "files; dump one-line summary of each read to stdout",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--output",
                        help="Output PNG filename. Default: summaries only")
    parser.add_argument("--maxlegendsize", type=Positive(int), default=10,
                        help="Maximum number of reads in legend")
    parser.add_argument("--nreads", type=Positive(int), default=10,
                        help="Max reads per file (unless read_ids given)")
    parser.add_argument("--read_ids", nargs="+", default=[],
                        help="Specific read ids to plot")
    parser.add_argument("--xmin", default=None, type=float)
    parser.add_argument("--xmax", default=None, type=float)
    parser.add_argument("--ymin", default=None, type=float)
    parser.add_argument("--ymax", default=None, type=float)
    parser.add_argument("--line_transparency", type=float, default=1.0)
    parser.add_argument("--zero_signal_start", action="store_true",
                        help="Start signal locations at zero")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("mapped_signal_files", nargs="+",
                        help="One or more mapped signal files")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    plt = None
    if args.output is not None:
        plt = require_pyplot("plot_mapped_signals --output")
        plt.figure(figsize=(12, 10))
    reads_sofar = 0
    for nfile, ms_fn in enumerate(args.mapped_signal_files):
        with MappedSignalReader(ms_fn) as msr:
            if args.read_ids:
                read_ids = args.read_ids
            else:
                read_ids = msr.get_read_ids()[:args.nreads]
                if not args.quiet:
                    sys.stderr.write(
                        "Reading first {} read ids in file {}\n".format(
                            args.nreads, ms_fn))
            # the given order kept, absent ids named
            present = set(msr.get_read_ids())
            for rid in read_ids:
                if rid not in present:
                    sys.stderr.write("* Warning: read id {} not in {}\n"
                                     .format(rid, ms_fn))
            ordered = (msr.get_read(rid) for rid in read_ids
                       if rid in present)
            for nread, read in enumerate(ordered):
                mapped = read.Ref_to_signal >= 0
                if mapped.sum() == 0:
                    continue
                rts = read.Ref_to_signal.copy()
                if args.zero_signal_start:
                    rts[mapped] -= rts[mapped][0]
                info = "file {} read {}:{} reflen:{}, daclen:{}".format(
                    nfile, nread, read.read_id, len(rts) - 1,
                    len(read.Dacs))
                if not args.quiet:
                    sys.stdout.write(info + "\n")
                if plt is not None:
                    x = np.arange(len(rts))[mapped]
                    y = rts[mapped]
                    for lim, ref, keep_above in (
                            (args.xmin, "x", True), (args.xmax, "x", False),
                            (args.ymin, "y", True), (args.ymax, "y", False)):
                        if lim is None:
                            continue
                        vals = x if ref == "x" else y
                        keep = vals >= lim if keep_above else vals <= lim
                        x, y = x[keep], y[keep]
                    plt.plot(x, y,
                             label=(info if reads_sofar < args.maxlegendsize
                                    else None),
                             linestyle="dashed" if nfile == 1 else "solid",
                             alpha=args.line_transparency)
                reads_sofar += 1
    if plt is not None:
        plt.grid()
        plt.xlabel("Reference location")
        plt.ylabel("Signal location")
        plt.legend(loc="upper left", framealpha=0.3)
        plt.tight_layout()
        if not args.quiet:
            sys.stderr.write("Saving plot to {}\n".format(args.output))
        plt.savefig(args.output)
        plt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
