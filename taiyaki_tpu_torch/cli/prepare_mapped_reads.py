"""Prepare training data: remap raw reads to their references with a
flip-flop model and write a mapped-signal file (port of
bin/prepare_mapped_reads.py).

    python -m taiyaki_tpu_torch.cli.prepare_mapped_reads [options] \\
        reads/ readparams.tsv mapped.hdf5 model.checkpoint references.fa

On the card (the default --device) one process remaps: --jobs IO threads
stage the reads, which are forwarded 8 at a time in batches of one padded
length (the network's kernels) and finished on the host (the glocal
Viterbi of `flipflop_remap`, C++).  With --device cpu each read is
remapped on its own by `oneread_remap`, in --jobs worker processes, as
the JAX CLI does.  The card path forks no process (no fork after CUDA);
a caller that has used the card and runs the CPU path in the same
process passes --jobs 1, since forked workers of such a process hang.  The
output is the JAX CLI's: the same file layouts (--batch_format), stdout
and stderr tallies.  All arithmetic is f32 (TF32 is switched off).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from taiyaki_tpu_torch.ops.rnn import f32_inference
from taiyaki_tpu_torch.utils.cmdargs import FileExists, Maybe
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Prepare data for model training and save to hdf5 file "
                    "by remapping with flip-flop model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(
        parser, ("alphabet device input_folder input_strand_list jobs limit "
                 "overwrite recursive version").split())
    parser.add_argument(
        "--localpen", metavar="penalty", default=0.0, type=float,
        help="Score cost for clipped (local) remapping")
    parser.add_argument(
        "--max_read_length", metavar="bases", default=None, type=Maybe(int),
        help="Don't attempt remapping for reads longer than this")
    parser.add_argument(
        "--mod", nargs=3,
        metavar=("mod_base", "canonical_base", "mod_long_name"),
        default=[], action="append",
        help="Modified-base definition (mod, canonical base, long name)")
    parser.add_argument(
        "--batch_format", action="store_true",
        help="Output batched mapped signal file format (better I/O "
             "performance and less disk space).")
    parser.add_argument(
        "input_per_read_params", action=FileExists,
        help="Per-read parameter TSV (from generate_per_read_params)")
    parser.add_argument("output", help="Destination mapped-signal HDF5 file")
    parser.add_argument("model", action=FileExists,
                        help="Model file (.checkpoint or .py)")
    parser.add_argument(
        "references", action=FileExists,
        help="Fasta with one ground-truth reference per read id")
    return parser


def main(argv=None):
    """Remap the reads; returns the reads written, the failures by reason,
    the samples remapped, the wall time and, on the card, the seconds of
    staging, forwards and host finish."""
    with f32_inference():
        return _main(argv)


def _main(argv=None):
    args = get_parser().parse_args(argv)
    print("Running prepare_mapping using flip-flop remapping")

    if not args.overwrite and os.path.exists(args.output):
        print("Cowardly refusing to overwrite {}".format(args.output))
        sys.exit(1)

    # f32 end to end, as the JAX CLI forces f32 gates, scores and matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from taiyaki_tpu_torch.cli.basecall import select_device
    device = select_device(args.device)

    from taiyaki_tpu_torch import alphabet, bio
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.iterators import imap_mp
    from taiyaki_tpu_torch.prepare_mapping_funcs import (
        batched_remap_results, generate_output_from_results,
        get_per_read_params_dict_from_tsv, oneread_remap)
    from taiyaki_tpu_torch.utils import helpers

    modified_bases = [elt[0] for elt in args.mod]
    canonical_bases = [elt[1] for elt in args.mod]
    for b in modified_bases:
        assert len(b) == 1, (
            "Modified bases must be a single character, got {}".format(b))
        assert b not in args.alphabet, (
            "Modified base must not be a canonical base, got {}".format(b))
    for b in canonical_bases:
        assert len(b) == 1, (
            "Canonical coding for modified bases must be a single "
            "character, got {}".format(b))
        assert b in args.alphabet, (
            "Canonical coding for modified base must be a canonical base, "
            "got {}".format(b))
    full_alphabet = args.alphabet + "".join(modified_bases)
    flat_alphabet = args.alphabet + "".join(canonical_bases)
    modification_names = [elt[2] for elt in args.mod]
    alphabet_info = alphabet.AlphabetInfo(
        full_alphabet, flat_alphabet, modification_names, do_reorder=True)
    print("Converting references to labels using {}".format(alphabet_info))

    fast5_reads = fast5utils.iterate_fast5_reads(
        args.input_folder, limit=args.limit,
        strand_list=args.input_strand_list, recursive=args.recursive)

    net, params, _, _, _, _ = helpers.load_model(args.model)
    if params is None:
        params = net.init(np.random.default_rng(0))
        sys.stderr.write("* Warning: remapping with a freshly initialised "
                         "model — pass a .checkpoint for real use.\n")
    net = load_jax_params(net, params).to(device).eval()

    kwargs = {
        "net": net,
        "per_read_params_dict": get_per_read_params_dict_from_tsv(
            args.input_per_read_params),
        "alphabet_info": alphabet_info,
        "max_read_length": args.max_read_length,
        "localpen": args.localpen,
    }

    nsample = 0

    def iter_jobs():
        references = bio.fasta_file_to_dict(args.references,
                                            alphabet=full_alphabet)
        for fn, read_id in fast5_reads:
            yield fn, read_id, references.get(read_id, None)

    def counted(results):
        nonlocal nsample
        for resultdict, mesg in results:
            if resultdict is not None:
                nsample += len(resultdict["Dacs"])
            yield resultdict, mesg

    t0 = time.time()
    timings = {}
    if device.type != "cpu":
        # One process drives the card with batched forwards; --jobs sizes
        # the IO thread pool (no worker processes: no fork after CUDA)
        results = batched_remap_results(
            iter_jobs(), io_threads=args.jobs, timings=timings, **kwargs)
    else:
        if args.limit is not None:
            chunksize = int(np.clip(args.limit // (2 * args.jobs), 1, 50))
        else:
            chunksize = 50
        results = imap_mp(
            oneread_remap, iter_jobs(), threads=args.jobs,
            fix_kwargs=kwargs, unordered=True, chunksize=chunksize)
    nmapped, failures = generate_output_from_results(
        counted(results), args.output, alphabet_info,
        batch_format=args.batch_format)
    return dict(nmapped=nmapped, failures=failures, nsample=nsample,
                seconds=time.time() - t0, device=str(device), **timings)


if __name__ == "__main__":
    main()
