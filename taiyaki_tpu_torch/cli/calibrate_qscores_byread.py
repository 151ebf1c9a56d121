"""Calibrate q-scores as a predictor of per-read error rate (port of
misc/calibrate_qscores_byread.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.calibrate_qscores_byread --fastq calls.fq --alignment_summary calls.samacc

Regresses each read's alignment-derived q-score (from its accuracy,
capped at --max_alignment_score) on its fastq's mean q-score with a
Huber robust regression (IRLS), over reads covered past
--coverage_threshold with a mean q-score of at least --min_fastqscore,
and prints the slope and shift that basecall's --qscore_scale and
--qscore_offset take.  The alignment summary is a Guppy summary or the
.samacc of `cli.assess_alignment`.  Where fewer than two reads pass the
filters there is no line to fit: stderr says so and the exit code is 1
(the JAX tool fails in its plot there).  The fit is drawn to --plot_filename
where matplotlib is installed; where it is not, stderr says that no
plot was written and the exit code stays 0.
"""

import argparse
import os
import sys
from collections import defaultdict

import numpy as np

from taiyaki_tpu_torch.utils import fileio
from taiyaki_tpu_torch.utils.plotting import pyplot


def get_parser():
    parser = argparse.ArgumentParser(
        description="Calculate parameters to correct qscores as predictor "
                    "of per-read error rate",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--alignment_summary", default=None,
                        help="tsv file containing alignment summary")
    parser.add_argument("--coverage_threshold", default=0.8, type=float,
                        help="Skip reads below this alignment coverage")
    parser.add_argument("--max_alignment_score", default=40.0, type=float,
                        help="Upper limit on score calculated from "
                             "alignment")
    parser.add_argument("--min_fastqscore", default=7.0, type=float,
                        help="Floor applied to the fastq-derived score")
    parser.add_argument("--fastq", default=None, help="Input fastq file")
    parser.add_argument("--input_directory", default=None,
                        help="Directory containing fastq files and "
                             "alignment_summary.txt")
    parser.add_argument("--maxreads", default=None, type=int,
                        help="Max reads to process")
    parser.add_argument("--plot_title", default=None)
    parser.add_argument("--plot_filename",
                        default="qscore_calibration.png")
    return parser


def iter_fastq(path):
    """Yield (read_id, seq, qual string)."""
    with open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            if not header.strip():
                continue  # trailing blank line / concatenation artifact
            seq = fh.readline().strip()
            fh.readline()
            qual = fh.readline().strip()
            yield header[1:].split()[0], seq, qual


def fastq_file_qscore(qvector):
    """Mean q-score in probability space."""
    p = np.power(10.0, -qvector.astype(np.float64) / 10.0)
    return -10.0 * np.log10(np.mean(p))


def read_fastqs(fastqlist, maxreads=None):
    read_ids, meanqs, lens = [], [], []
    for path in fastqlist:
        for rid, seq, qual in iter_fastq(path):
            scores = np.frombuffer(qual.encode(), dtype=np.uint8) - 33
            read_ids.append(rid)
            lens.append(len(scores))
            meanqs.append(fastq_file_qscore(scores) if len(scores)
                          else np.nan)
            if maxreads is not None and len(read_ids) >= maxreads:
                return (np.array(read_ids), np.array(meanqs),
                        np.array(lens))
    return np.array(read_ids), np.array(meanqs), np.array(lens)


def get_alignment_data(alignment_file):
    """Accuracy + aligned length per read from a Guppy summary or a
    .samacc of `cli.assess_alignment` (space-separated: any whitespace
    splits either)."""
    t = fileio.readtsv(alignment_file, delimiter=None)
    names = t.dtype.names
    if "alignment_accuracy" in names:
        print("Interpreted alignment file as Guppy output")
        acc = np.asarray(t["alignment_accuracy"], dtype=float)
        acc[acc < 0] = np.nan
        return (t["read_id"], acc,
                t["alignment_strand_end"] - t["alignment_strand_start"])
    if "accuracy" in names:
        print("Interpreted alignment file as samacc output")
        lens = (t["reference_end"] - t["reference_start"]
                + t["insertion"] - t["deletion"])
        return t["query"], np.asarray(t["accuracy"], dtype=float), lens
    raise Exception("Unrecognised alignment summary columns: {}".format(
        names))


def merge_align_fastq_data(fastq_ids, align_ids, align_acc, align_lens):
    """Best alignment per fastq read (NaN accuracies, rows that did not
    align, never win over a real alignment)."""
    n = len(fastq_ids)
    out_acc = np.full(n, np.nan)
    out_len = np.full(n, -1)
    align_lens = np.asarray(align_lens)
    by_id = defaultdict(list)
    for j, aid in enumerate(align_ids):
        by_id[str(aid)].append(j)
    for i, rid in enumerate(fastq_ids):
        idx = by_id.get(rid)
        if not idx:
            continue
        accs = align_acc[idx]
        if np.isnan(accs).all():
            continue
        best = int(np.nanargmax(accs))
        out_acc[i] = accs[best]
        out_len[i] = align_lens[idx][best]
    return out_acc, out_len


def huber_regression(x, y, k=1.345, niter=50):
    """Robust linear fit y ~ c + m*x via IRLS with Huber weights."""
    X = np.stack([np.ones_like(x), x], axis=1)
    w = np.ones_like(x)
    c = m = 0.0
    for _ in range(niter):
        W = X * w[:, None]
        beta, *_ = np.linalg.lstsq(W.T @ X, W.T @ y, rcond=None)
        resid = y - X @ beta
        s = np.median(np.abs(resid)) / 0.6745 + 1e-12
        r = np.abs(resid) / s
        w = np.where(r <= k, 1.0, k / r)
        c, m = beta
    return c, m


def plot_fit(plt, meanqs, y, c, m, title, path):
    """The reads' scores and the fit, saved to `path`."""
    plt.scatter(meanqs, y, s=2)
    xx = np.array([meanqs.min(), meanqs.max()])
    plt.plot(xx, c + m * xx, color="gray",
             label="slope={:3.2f} intercept={:3.2f}".format(m, c))
    plt.plot(xx, xx, color="gray", linestyle="dotted", label="y=x")
    plt.legend(loc="upper left", framealpha=0.1)
    plt.xlabel("Fastq q score")
    plt.ylabel("Alignment accuracy score")
    plt.grid()
    if title is not None:
        plt.title(title)
    plt.savefig(path)
    plt.close()


def main(argv=None):
    print("Calculating shift and scale parameters to calibrate per-read")
    print("accuracy estimates from q scores.")
    args = get_parser().parse_args(argv)
    fastqlist = None
    alignment_summary_file = None
    if args.input_directory is not None:
        fastqlist = sorted(
            os.path.join(args.input_directory, f)
            for f in os.listdir(args.input_directory)
            if f.endswith(".fastq"))
        if not fastqlist:
            raise Exception("No fastq files found in {}".format(
                args.input_directory))
        alignment_summary_file = os.path.join(args.input_directory,
                                              "alignment_summary.txt")
    if args.fastq is not None:
        fastqlist = [args.fastq]
    if args.alignment_summary is not None:
        alignment_summary_file = args.alignment_summary
    if fastqlist is None:
        raise Exception("Supply --input_directory or --fastq")

    fastq_ids, fastq_meanqs, fastq_lens = read_fastqs(fastqlist,
                                                      args.maxreads)
    align_ids, align_acc, align_lens = get_alignment_data(
        alignment_summary_file)
    accuracies, fq_align_lens = merge_align_fastq_data(
        fastq_ids, align_ids, align_acc, align_lens)

    keep = (~np.isnan(accuracies)
            & (fq_align_lens / np.maximum(fastq_lens, 1)
               > args.coverage_threshold)
            & (fastq_meanqs >= args.min_fastqscore))
    print("Total number of reads =", len(accuracies))
    print("    After filtering:", int(keep.sum()))
    if keep.sum() < 2:
        sys.stderr.write("* Error: {} reads pass the filters: at least 2 "
                         "are needed to fit a line\n".format(int(keep.sum())))
        return 1
    accuracies, meanqs = accuracies[keep], fastq_meanqs[keep]

    y = -10.0 * np.log10(np.maximum(1.0 - accuracies, 1e-10))
    y = np.minimum(y, args.max_alignment_score)
    c, m = huber_regression(meanqs, y)

    print("\n\nBest-fit:", args.plot_title)
    print("Best-fit slope (qscore_scale) = {:3.4f}".format(m))
    print("Best-fit shift (qscore_shift) = {:3.4f}".format(c))
    plt = pyplot()
    if plt is None:
        sys.stderr.write("matplotlib is not installed: no plot written to "
                         "{}\n".format(args.plot_filename))
        return 0
    print("\nSaving plot to {}".format(args.plot_filename))
    plot_fit(plt, meanqs, y, c, m, args.plot_title, args.plot_filename)
    return 0


if __name__ == "__main__":
    sys.exit(main())
