"""Plot training and validation loss curves from training output
directories (port of misc/plot_training.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.plot_training [options] out.png training_dir [...]

Each directory's batch.log losses (with --mav, a moving average) and its
validation.log losses, one colour a directory.  Needs matplotlib: where
it is not installed, exits non-zero naming it and writes nothing.
"""

import argparse
import os
import sys

import numpy as np

from taiyaki_tpu_torch.constants import BATCH_LOG_FILENAME, VALID_LOG_FILENAME
from taiyaki_tpu_torch.utils import fileio
from taiyaki_tpu_torch.utils.cmdargs import Positive
from taiyaki_tpu_torch.utils.plotting import require_pyplot


def get_parser():
    parser = argparse.ArgumentParser(
        description="Plot graphs of training loss",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "--mav", default=None, type=int,
        help="Moving average window applied to batchlog loss")
    parser.add_argument("--upper_y_limit", default=None,
                        type=Positive(float))
    parser.add_argument("--lower_y_limit", default=None,
                        type=Positive(float))
    parser.add_argument("--upper_x_limit", default=None,
                        type=Positive(float))
    parser.add_argument("--lower_x_limit", default=None,
                        type=Positive(float))
    parser.add_argument("output", help="Destination png path")
    parser.add_argument(
        "input_directories", nargs="+",
        help="Training output directories (each holding {} and {})".format(
            BATCH_LOG_FILENAME, VALID_LOG_FILENAME))
    return parser


def moving_average(a, n=3):
    """Moving average; shorter prefixes average what is available."""
    x = np.cumsum(a, dtype=float)
    m = len(x)
    if m > n:
        x[n:] = (x[n:] - x[:-n]) / n
    x[:n] = x[:n] / np.arange(1, min(n, m) + 1)
    return x


def main(argv=None):
    args = get_parser().parse_args(argv)
    plt = require_pyplot("plot_training")
    plt.figure(figsize=(6, 4.8))
    colours = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    for td, colour in zip(args.input_directories, colours):
        label = os.path.basename(os.path.normpath(td))
        batch = fileio.readtsv(os.path.join(td, BATCH_LOG_FILENAME))
        loss = np.asarray(batch["loss"], dtype=float)
        if args.mav is not None:
            loss = moving_average(loss, args.mav)
        plt.plot(batch["iter"], loss, color=colour,
                 label=label + " (training)", alpha=0.5, linewidth=0.5)
        val = fileio.readtsv(os.path.join(td, VALID_LOG_FILENAME))
        if len(np.atleast_1d(val["iter"])) == 0:
            print("No validation log data for {}.".format(td))
            continue
        plt.plot(val["iter"], val["loss"], color=colour,
                 label=label + " (validation)", linewidth=0.5)
    plt.grid()
    plt.xlabel("Iterations")
    plt.ylabel("Loss")
    if args.upper_y_limit is not None:
        plt.ylim(top=args.upper_y_limit)
    if args.lower_y_limit is not None:
        plt.ylim(bottom=args.lower_y_limit)
    if args.upper_x_limit is not None:
        plt.xlim(right=args.upper_x_limit)
    if args.lower_x_limit is not None:
        plt.xlim(left=args.lower_x_limit)
    leg = plt.legend(loc="upper right")
    for legobj in leg.legend_handles:
        legobj.set_linewidth(4.0)
    if args.mav is not None:
        plt.title("Moving average window = {} iterations".format(args.mav))
    plt.tight_layout()
    plt.savefig(args.output, dpi=300)
    plt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
