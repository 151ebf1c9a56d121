"""Plot a histogram of read accuracies from an alignment summary (port of
misc/plot_accuracy_histogram_from_alignment_summary.py; host only, no
device).

    python -m taiyaki_tpu_torch.cli.plot_accuracy_histogram_from_alignment_summary [options] summary.tsv

The alignment_accuracy column's non-negative values in --bins bins, to
--output_name.  Needs matplotlib: where it is not installed, exits
non-zero naming it and writes nothing.
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import FileExists, Positive
from taiyaki_tpu_torch.utils.fileio import readtsv
from taiyaki_tpu_torch.utils.plotting import require_pyplot


def get_parser():
    parser = argparse.ArgumentParser(
        description="Plot an accuracy histogram from a combined read file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("combined_read_file", action=FileExists,
                        help="Alignment summary TSV to plot")
    parser.add_argument("--bins", default=100, type=Positive(int),
                        help="Histogram bin count")
    parser.add_argument("--title", default="", help="Title drawn above the plot")
    parser.add_argument("--output_name",
                        default="basecaller_histogram.png",
                        help="Path for the rendered figure")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    plt = require_pyplot("plot_accuracy_histogram_from_alignment_summary")
    acc = np.asarray(readtsv(args.combined_read_file)["alignment_accuracy"],
                     dtype=float)
    fig, ax = plt.subplots()
    ax.set_title(bytes(args.title, "utf-8").decode("unicode_escape"),
                 fontsize=7)
    ax.set_xlabel("Accuracy")
    ax.set_ylabel("Reads")
    ax.minorticks_on()
    ax.grid(which="major", linestyle=":")
    ax.grid(which="minor", linestyle=":")
    plt.hist(acc[acc >= 0], bins=args.bins)
    plt.tight_layout()
    plt.savefig(args.output_name)
    plt.close(fig)
    return 0


if __name__ == "__main__":
    sys.exit(main())
