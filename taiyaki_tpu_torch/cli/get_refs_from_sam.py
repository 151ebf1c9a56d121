"""Extract per-read ground-truth reference sequences from SAM/BAM
alignments (port of bin/get_refs_from_sam.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.get_refs_from_sam [--output refs.fa] \
        genome.fa alignments.sam [more.bam ...]
"""

import argparse
import sys

from taiyaki_tpu_torch.bio import (
    complement, fasta_file_to_dict, reverse_complement)
from taiyaki_tpu_torch.sam import iter_alignments
from taiyaki_tpu_torch.utils.cmdargs import (
    AutoBool, FileExists, proportion)
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args
from taiyaki_tpu_torch.utils.fileio import readtsv
from taiyaki_tpu_torch.utils.helpers import open_file_or_stdout


def get_parser():
    parser = argparse.ArgumentParser(
        description="Extract reference sequence for each read from a SAM "
                    "alignment file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, ["output"])
    parser.add_argument(
        "--complement", default=False, action=AutoBool,
        help="Emit the complement of every reference sequence")
    parser.add_argument(
        "--input_strand_list", default=None, action=FileExists,
        help="TSV (read_id column) restricting which reads are used")
    parser.add_argument(
        "--min_coverage", metavar="proportion", default=0.6,
        type=proportion,
        help="Skip reads whose alignment covers less than min_coverage * "
             "read length")
    parser.add_argument(
        "--pad", type=int, default=0,
        help="Extra flanking bases to keep on each side of the alignment")
    parser.add_argument(
        "--reverse", default=False, action=AutoBool,
        help="Emit reference sequences reversed (RNA)")
    parser.add_argument(
        "reference", action=FileExists,
        help="Fasta of the genome the alignments refer to")
    parser.add_argument(
        "input", metavar="input.sam", nargs="+",
        help="Alignment file(s) (SAM/BAM) of the reads against the genome")
    return parser


def get_refs(samfile, ref_seq_dict, min_coverage=0.6, pad=0,
             strand_list=None):
    """Yield (read_id, reference substring) for primary, well-covered
    alignments (flags 0 / 16 only, like the reference)."""
    for aln in iter_alignments(samfile):
        if aln.flag not in (0, 16):
            continue
        if strand_list is not None and aln.query_name not in strand_list:
            continue
        qlen = aln.query_length
        if qlen == 0 or aln.query_alignment_length / qlen < min_coverage:
            continue
        read_ref = ref_seq_dict.get(aln.reference_name)
        if read_ref is None:
            continue
        start = max(0, aln.reference_start - pad)
        end = min(len(read_ref), aln.reference_end + pad)
        seq = read_ref[start:end].upper()
        if aln.flag == 16:
            seq = reverse_complement(seq)
        yield aln.query_name, seq


def main(argv=None):
    args = get_parser().parse_args(argv)
    sys.stderr.write(
        "* Loading references (this may take a while for large genomes)\n")
    references = fasta_file_to_dict(args.reference, filter_ambig=False)

    strand_list = None
    if args.input_strand_list is not None:
        strand_list = set(
            str(v) for v in readtsv(args.input_strand_list,
                                    fields=["read_id"])["read_id"])
        sys.stderr.write("* Strand list contains {} reads\n".format(
            len(strand_list)))

    sys.stderr.write("* Extracting read references using SAM alignment\n")
    with open_file_or_stdout(args.output) as fh:
        for samfile in args.input:
            for name, read_ref in get_refs(samfile, references,
                                           args.min_coverage, args.pad,
                                           strand_list):
                if args.reverse:
                    read_ref = read_ref[::-1]
                if args.complement:
                    read_ref = complement(read_ref)
                fh.write(">{}\n{}\n".format(name, read_ref))


if __name__ == "__main__":
    main()
