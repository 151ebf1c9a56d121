"""Accuracy statistics from read alignments (port of
misc/assess_alignment.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.assess_alignment [options] reads.sam [more.bam ...]

For each SAM/BAM file: the best primary alignment of each read (flags 0
and 16) covering at least --coverage of it gives the read's metrics
(`ACC_METRICS`); they go to <prefix>.samacc, a summary report (mean, mode
and quantiles of the accuracy, the CIscore) to stdout and
<prefix>.summary, and a histogram of the accuracies to
<prefix>.<figure_format>.  The outputs and exit codes are the JAX tool's.
matplotlib is imported only to write the plot: where it is not installed,
every other output is written and stderr says that no plot was.
"""

import argparse
import os
import sys
import traceback
from collections import namedtuple

import numpy as np

from taiyaki_tpu_torch.sam import iter_alignments
from taiyaki_tpu_torch.utils.cmdargs import AutoBool, proportion

ACC_METRICS = namedtuple("ACC_METRICS", (
    "reference", "query", "strand", "reference_start", "reference_end",
    "match", "mismatch", "insertion", "deletion", "coverage", "id",
    "accuracy", "information"))

DEFAULT_QUANTILES = [5, 25, 50, 75, 95]

INVALID_SUMM = "*** Summary report for {} ***\nNo sequences mapped\n"
VALID_SUMM = """*** Summary report for {} ***
Number of mapped reads:  {}
Mean accuracy:  {:.5f}
Mode accuracy:  {:.5f}
Accuracy quantiles:
  {}
  {}
Proportion with accuracy >90%:  {:.5f}
Number with accuracy >90%:  {}
CIscore (Mbits): {:.5f}
"""


def get_parser():
    parser = argparse.ArgumentParser(
        description="Compute read accuracy statistics from alignments",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--coverage", default=0.6, metavar="proportion",
                        type=proportion, help="Coverage floor for including an alignment")
    parser.add_argument("--data_name", default=None,
                        help="Data name (default: from filename)")
    parser.add_argument("--figure_format", default="png",
                        help="Figure file format")
    parser.add_argument("--output_plot", default=True, action=AutoBool,
                        help="Output accuracy plot")
    parser.add_argument("--output_text", default=True, action=AutoBool,
                        help="Output per-read accuracy TSV (.samacc)")
    parser.add_argument("--quantiles", nargs="+", type=int,
                        default=DEFAULT_QUANTILES)
    parser.add_argument("--show_median", default=False, action=AutoBool,
                        help="Show median accuracy on plot")
    parser.add_argument("files", nargs="+",
                        help="SAM/BAM alignment file(s)")
    return parser


_CIGAR_BIN = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
              "=": 7, "X": 8}


def samacc(align_fn, min_coverage=0.6):
    """Per-read accuracy metrics (the best alignment of each query)."""
    res = {}
    for read in iter_alignments(align_fn):
        if read.flag not in (0, 16):
            continue
        qlen = read.query_length
        if qlen == 0:
            continue
        coverage = read.query_alignment_length / qlen
        if coverage < min_coverage:
            continue
        bins = np.zeros(9, dtype="i4")
        for op, count in read.cigar:
            bins[_CIGAR_BIN[op]] += count
        alnlen = int(bins[:3].sum())
        try:
            mismatch = read.get_tag("NM")
        except KeyError:
            raise NotImplementedError(
                "Alignment mismatch counting currently requires NM tag.")
        correct = alnlen - mismatch
        readlen = int(bins[0] + bins[1])
        perr = min(0.75, mismatch / readlen)
        pmatch = 1.0 - perr
        accuracy = correct / alnlen
        entropy = pmatch * np.log2(pmatch)
        if mismatch > 0:
            entropy += perr * np.log2(perr / 3.0)
        prev = res.get(read.query_name)
        if prev is None or prev.accuracy < accuracy:
            res[read.query_name] = ACC_METRICS(
                reference=read.reference_name, query=read.query_name,
                strand="-" if read.is_reverse else "+",
                reference_start=read.reference_start,
                reference_end=read.reference_end,
                match=int(bins[0]), mismatch=mismatch,
                insertion=int(bins[1]), deletion=int(bins[2]),
                coverage=coverage, id=correct / float(bins[0]),
                accuracy=accuracy,
                information=bins[0] * (2.0 + entropy))
    return list(res.values())


def acc_plot(acc, mode, median, title):
    """A histogram of the accuracies with the mode (and the median) marked;
    (figure, axes).  Imports matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    f, ax = plt.subplots()
    ax.hist(acc, bins=min(100, max(10, len(acc) // 2)), density=True,
            alpha=0.6)
    ax.axvline(mode, color="r", label="mode {:.4f}".format(mode))
    if median is not None:
        ax.axvline(median, color="g", label="median {:.4f}".format(median))
    ax.set_xlabel("Accuracy")
    ax.set_ylabel("Density")
    ax.set_title(title)
    ax.legend()
    return f, ax


def summary(acc_dat, data_name, show_median, quants):
    """The report text, and the arguments of `acc_plot` for its histogram
    (None when nothing mapped)."""
    if len(acc_dat) == 0:
        return INVALID_SUMM.format(data_name), None
    acc = np.array([r.accuracy for r in acc_dat])
    ciscore = np.array([r.information for r in acc_dat])
    mean = acc.mean()
    if len(acc) > 1:
        try:
            from scipy.optimize import minimize_scalar
            from scipy.stats import gaussian_kde
            da = gaussian_kde(acc)
            opt = minimize_scalar(lambda x: -da(x), bounds=(0, 1),
                                  method="Bounded")
            mode = float(np.atleast_1d(opt.x)[0]) if opt.success else 0.0
        except Exception:
            sys.stderr.write("Mode computation failed\n")
            mode = 0.0
    else:
        mode = float(acc[0])
    qstring1 = "".join("Q{:<11}".format(q) for q in quants).strip()
    qstring2 = "    ".join("{:.5f}".format(v)
                           for v in np.percentile(acc, quants))
    median = float(np.median(acc)) if show_median else None
    report = VALID_SUMM.format(
        data_name, len(set(r.query for r in acc_dat)), mean, mode,
        qstring1, qstring2, (acc > 0.9).mean(), int((acc > 0.9).sum()),
        ciscore.sum() / 1e6)
    return report, (acc, mode, median,
                    "{} (n = {})".format(data_name, len(acc)))


def _save_plot(plot, path):
    """Write the histogram to `path`; False, with a line on stderr, where
    matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        sys.stderr.write("matplotlib is not installed: no plot written "
                         "to {}\n".format(path))
        return False
    f, _ = acc_plot(*plot)
    f.savefig(path)
    import matplotlib.pyplot as plt
    plt.close(f)
    return True


def main(argv=None):
    """Assess each file; returns the exit code (1 if any file failed)."""
    args = get_parser().parse_args(argv)
    exit_code = 0
    for fn in args.files:
        try:
            prefix, _ = os.path.splitext(fn)
            acc_dat = samacc(fn, min_coverage=args.coverage)
            if args.output_text and acc_dat:
                with open(prefix + ".samacc", "w") as fs:
                    fs.write(" ".join(ACC_METRICS._fields) + "\n")
                    fs.write("\n".join(
                        " ".join(map(str, r)) for r in acc_dat) + "\n")
            data_name = fn if args.data_name is None else args.data_name
            report, plot = summary(acc_dat, data_name, args.show_median,
                                   args.quantiles)
            if args.output_plot and plot is not None:
                _save_plot(plot, prefix + "." + args.figure_format)
            sys.stdout.write("\n" + report + "\n")
            with open(prefix + ".summary", "w") as fs:
                fs.writelines(report)
        except Exception:
            sys.stderr.write("{}: something went wrong, skipping\n\n{}\n"
                             .format(fn, traceback.format_exc()))
            exit_code = 1
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
