"""Align basecalls to a reference and assess their accuracy (port of
misc/align.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.align --reference refs.fa calls.fa [more.fq ...]

Each input that is not already SAM/BAM is aligned to --reference with
`bwa mem` where `bwa` is on PATH, else with the built-in exact glocal
aligner (`decodeutil.seq_align`, host C++; right for per-read
references, not for genome-scale mapping, see `builtin_align`), into
<prefix>.sam; then `cli.assess_alignment` runs on it in process.  The SAM
and the outputs and exit codes are the JAX tool's; the SAM's @PG line
names the port's aligner.
"""

import argparse
import gzip
import os
import shutil
import subprocess
import sys
import traceback

from taiyaki_tpu_torch.bio import reverse_complement
from taiyaki_tpu_torch.cli import assess_alignment
from taiyaki_tpu_torch.utils.cmdargs import AutoBool, proportion


def get_parser():
    parser = argparse.ArgumentParser(
        description="Align reads to reference and obtain accuracy metrics",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "--bwa_mem_args", metavar="args",
        default="-k14 -W20 -r10 -t 16 -A 1 -B 2 -O 2 -E 1",
        help="Extra flags forwarded to bwa mem")
    assess_grp = parser.add_argument_group("Alignment Assessment Arguments")
    assess_grp.add_argument("--coverage", metavar="proportion", default=0.6,
                            type=proportion, help="Coverage floor for including an alignment")
    assess_grp.add_argument("--data_name", default=None,
                            help="Label for the dataset (defaults to the file name).")
    assess_grp.add_argument("--figure_format", default="png",
                            help="Image format for saved figures.")
    assess_grp.add_argument("--show_median", default=False, action=AutoBool,
                            help="Annotate the histogram with the median")
    assess_grp.add_argument("--reference", default=None,
                            help="Fasta to align the queries against")
    parser.add_argument("files", metavar="input", nargs="+",
                        help="Query sequence file(s) to align")
    return parser


def call_bwa_mem(fin, fout, genome, clargs=""):
    """Run bwa mem; raises CalledProcessError on failure."""
    command_line = "bwa mem {} {} {} > {}".format(clargs, genome, fin, fout)
    return subprocess.check_output(command_line, stderr=subprocess.STDOUT,
                                   shell=True, universal_newlines=True)


def _open_text(fn):
    if fn.endswith(".gz"):
        return gzip.open(fn, "rt")
    return open(fn)


def _iter_fastx(fn):
    """(name, sequence) records from fasta or fastq (optionally .gz)."""
    with _open_text(fn) as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == ">":
            name, parts = None, []
            for line in fh:
                line = line.strip()
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(parts)
                    name, parts = line[1:].split()[0], []
                elif line:
                    parts.append(line)
            if name is not None:
                yield name, "".join(parts)
        else:
            while True:
                header = fh.readline()
                if not header or not header.strip():
                    return
                seq = fh.readline().strip()
                fh.readline()
                fh.readline()
                yield header[1:].split()[0], seq


def builtin_align(fin, fout, genome):
    """Align queries with the port's glocal affine aligner
    (`decodeutil.seq_align`) where bwa is unavailable.

    Every query is aligned against every reference sequence on both
    strands and the best-scoring hit is written as a SAM record with
    CIGAR, NM and AS, which is all the assessment reads.  Exact DP, no
    seeding: right for basecall-accuracy scale (reads against their known
    per-read references), not for genome-scale mapping; pairs whose DP
    matrix would exceed ~200 MB are skipped with a warning (use bwa for
    genome-scale references)."""
    from taiyaki_tpu_torch import decodeutil

    max_dp_cells = 2 * 10 ** 8   # ~200 MB of 1-byte traceback per pair
    warned_big = False
    refs = list(_iter_fastx(genome))
    with open(fout, "w") as out:
        out.write("@HD\tVN:1.6\tSO:unknown\n")
        for rname, rseq in refs:
            out.write("@SQ\tSN:{}\tLN:{}\n".format(rname, len(rseq)))
        out.write("@PG\tID:seq_align\tPN:taiyaki_tpu_torch.decodeutil."
                  "seq_align\n")
        for qname, qseq in _iter_fastx(fin):
            if not qseq:
                continue
            best = None
            for rname, rseq in refs:
                if not rseq:
                    continue
                if (len(qseq) + 1) * (len(rseq) + 1) > max_dp_cells:
                    if not warned_big:
                        warned_big = True
                        sys.stderr.write(
                            "builtin_align: reference %s too large for "
                            "the exact DP (>200 MB matrix); skipping "
                            "such pairs — use bwa for genome-scale "
                            "mapping.\n" % rname)
                    continue
                for flag, seq in ((0, qseq), (16, reverse_complement(qseq))):
                    score, rs, re, cigar, nm = decodeutil.seq_align(
                        seq, rseq)
                    if best is None or score > best[0]:
                        best = (score, flag, rname, rs, cigar, nm, seq)
            if best is None:
                out.write("{}\t4\t*\t0\t0\t*\t*\t0\t0\t{}\t*\n".format(
                    qname, qseq))
                continue
            score, flag, rname, rs, cigar, nm, seq = best
            cigstr = "".join("{}{}".format(n, op) for op, n in cigar)
            out.write("{}\t{}\t{}\t{}\t60\t{}\t*\t0\t0\t{}\t*\tNM:i:{}"
                      "\tAS:i:{}\n".format(
                          qname, flag, rname, rs + 1, cigstr, seq, nm,
                          score))
    return "Aligned {} with the built-in aligner.\n".format(fin)


def _have_bwa():
    return shutil.which("bwa") is not None


def _looks_like_alignment(fn):
    """SAM/BAM detection that cannot misfire on FASTQ: FASTQ records
    also start with '@' (and .fastq.gz shares the gzip magic), so
    require the BAM\\x01 magic after gunzip or a real SAM header tag
    (@HD/@SQ/@RG/@PG/@CO followed by a tab)."""
    with open(fn, "rb") as fh:
        head = fh.read(4)
    if head[:2] == b"\x1f\x8b":
        try:
            with gzip.open(fn, "rb") as gz:
                return gz.read(4) == b"BAM\x01"
        except OSError:
            return False
    try:
        with open(fn, "rt") as fh:
            line = fh.readline()
    except UnicodeDecodeError:
        return False
    tag = line[:3]
    return (line.startswith("@")
            and tag in ("@HD", "@SQ", "@RG", "@PG", "@CO")
            and (len(line) <= 3 or line[3] in "\t\n"))


def main(argv=None):
    """Align and assess each file; returns the exit code (1 if any file
    failed)."""
    args = get_parser().parse_args(argv)
    exit_code = 0
    for fn in args.files:
        if _looks_like_alignment(fn):
            align_fn = fn
        else:
            sys.stdout.write(
                "Input file does not appear to be a SAM/BAM file. "
                "Alignment will be performed.\n")
            align_fn = "{}.sam".format(os.path.splitext(fn)[0])
            sys.stdout.write("Aligning {}...\n".format(fn))
            try:
                if _have_bwa():
                    out = call_bwa_mem(fn, align_fn, args.reference,
                                       args.bwa_mem_args)
                else:
                    sys.stdout.write("bwa not found; using the built-in "
                                     "aligner.\n")
                    out = builtin_align(fn, align_fn, args.reference)
                sys.stdout.write(out)
            except Exception:
                sys.stderr.write("{}: something went wrong, skipping\n\n{}\n"
                                 .format(fn, traceback.format_exc()))
                exit_code = 1
                continue
        assess_args = [align_fn, "--coverage", str(args.coverage),
                       "--figure_format", str(args.figure_format)]
        if args.data_name is not None:
            assess_args.extend(["--data_name", str(args.data_name)])
        if args.show_median:
            assess_args.append("--show_median")
        try:
            exit_code = max(exit_code, assess_alignment.main(assess_args))
        except SystemExit as e:
            exit_code = max(exit_code, int(e.code or 0))
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
