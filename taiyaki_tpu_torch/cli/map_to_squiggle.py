"""Map observed signal to a predicted squiggle (port of
bin/map_to_squiggle.py).

    python -m taiyaki_tpu_torch.cli.map_to_squiggle [options] \\
        model.checkpoint references.fa reads/

For each fast5 read with a reference (read through h5py, or the port's
`data/hdf5.py` where h5py is absent): trim --trim samples, normalise by
median and MAD, predict the reference's squiggle with the network's
forward (on --device, the card by default) and align the signal to it
with the glocal squiggle-match Viterbi (host C++).  The output is the JAX
CLI's: a "#read_id score" line, then a row per sample (read_id, sample,
normalised current, position, base, and the position's level, log scale
and rate; -1, "-" and zeros in the clipped head and tail).
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import (
    FileExists, Maybe, NonNegative, proportion)
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Map sequence to current trace using squiggle "
                    "predictor model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser,
                            "device jobs limit output recursive version"
                            .split())
    parser.add_argument(
        "--back_prob", default=1e-15, metavar="probability",
        type=proportion, help="Chance of a backward step in the alignment")
    parser.add_argument(
        "--input_strand_list", default=None, action=FileExists,
        help="TSV (read_id column) restricting which reads are used")
    parser.add_argument(
        "--localpen", default=None, type=Maybe(NonNegative(float)),
        help="Cost of dwelling in the flanking start/end states; None to "
             "disable them")
    parser.add_argument(
        "--minscore", default=None, type=Maybe(NonNegative(float)),
        help="Score floor for accepting a match")
    parser.add_argument(
        "--trim", default=(200, 10), nargs=2, type=NonNegative(int),
        metavar=("beginning", "end"),
        help="Samples to discard at the read start and end")
    parser.add_argument("model", action=FileExists, help="Squiggle-model checkpoint")
    parser.add_argument("references", action=FileExists, help="Fasta of sequences to map against")
    parser.add_argument("read_dir", action=FileExists,
                        help="Directory of fast5 read files")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    import torch
    from taiyaki_tpu_torch.bio import fasta_file_to_dict
    from taiyaki_tpu_torch.cli.basecall import select_device
    from taiyaki_tpu_torch.cli.predict_squiggle import (
        load_squiggle_model, predict)
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.maths import mad
    from taiyaki_tpu_torch.ops.squiggle import squiggle_match_viterbi_path
    from taiyaki_tpu_torch.utils import helpers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = load_squiggle_model(args.model, select_device(args.device))
    references = fasta_file_to_dict(args.references, filter_ambig=False)

    fast5_reads = fast5utils.iterate_fast5_reads(
        args.read_dir, limit=args.limit,
        strand_list=args.input_strand_list, recursive=args.recursive)

    with helpers.open_file_or_stdout(args.output) as fh:
        for fast5_name, read_id in fast5_reads:
            refseq = references.get(read_id)
            if refseq is None:
                sys.stderr.write("Reference not found for {}\n"
                                 .format(read_id))
                continue
            try:
                with fast5utils.get_fast5_file(fast5_name) as f5:
                    signal = f5.get_read(read_id).get_raw_data()
            except Exception:
                sys.stderr.write("Error reading {}\n".format(read_id))
                continue
            t0, t1 = args.trim
            signal = signal[t0:len(signal) - t1]
            if len(signal) == 0:
                continue
            norm_sig = ((signal - np.median(signal))
                        / mad(signal)).astype(np.float32)
            squiggle_params = predict(net, refseq)
            score, path = squiggle_match_viterbi_path(
                squiggle_params, norm_sig, args.back_prob, args.localpen,
                args.minscore)
            fh.write("#{} {}\n".format(read_id, -score))
            for i, (s, p) in enumerate(zip(norm_sig, path)):
                base = refseq[p] if p >= 0 else "-"
                sp = squiggle_params[p] if p >= 0 else (0.0, 0.0, 0.0)
                fh.write("{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n".format(
                    read_id, i, s, p, base, sp[0], sp[1], sp[2]))


if __name__ == "__main__":
    main()
