"""Merge mapped-signal files into one, checking that their alphabets agree
(port of misc/merge_mappedsignalfiles.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.merge_mappedsignalfiles merged.hdf5 \\
        --input a.hdf5 None --input b.hdf5 1000 [--allow_mod_merge]

Each --input names a file and how many of its reads to take ("None": all;
fewer than it holds: a random choice under --seed).  A read id already
written is skipped.  With --allow_mod_merge the files may carry different
modified bases: their alphabets are merged (a union, with no single-letter
code reused for another base) and each read's Reference labels are
re-coded into the merged alphabet.  The inputs are read, and the output
written, through h5py where it is installed, else through the port's
data/hdf5.py.
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.alphabet import AlphabetInfo
from taiyaki_tpu_torch.data.mapped_signal_files import (
    MappedSignalReader, MappedSignalWriter, _version as msf_version)
from taiyaki_tpu_torch.utils.cmdargs import AutoBool, Maybe, NonNegative


def get_parser():
    parser = argparse.ArgumentParser(
        description="Combine mapped-signal files into a single file. "
                    "Checks that alphabets are compatible.")
    parser.add_argument("output", help="Merged output HDF5 path")
    parser.add_argument(
        "--input", required=True, nargs=2, action="append",
        metavar=("mapped_signal_file", "num_reads"),
        help='Input file and number of reads to merge ("None" = all)')
    parser.add_argument(
        "--load_in_mem", action=AutoBool, default=True,
        help="Load each input file into memory before processing")
    parser.add_argument(
        "--seed", type=Maybe(NonNegative(int)), default=None,
        help="Seed for randomly selected reads when limits are set")
    parser.add_argument(
        "--allow_mod_merge", action="store_true",
        help="Allow merging of data sets with different modified bases")
    parser.add_argument(
        "--batch_format", action="store_true",
        help="Output batched mapped signal file format")
    return parser


def open_checked(fn, **kwargs):
    """A mapped-signal reader of `fn`; exits with a message naming the
    file where its format version is not this build's."""
    try:
        return MappedSignalReader(fn, **kwargs)
    except ValueError as e:
        sys.exit("File version of {} does not match this build's format "
                 "version ({}): {}".format(fn, msf_version, e))


def merge_alphabets(in_fns):
    """Union of alphabets across files; errors on inconsistent codes."""
    all_ai = []
    for fn in in_fns:
        with open_checked(fn) as msr:
            all_ai.append(msr.get_alphabet_information())
    can_bases = all_ai[0].can_bases
    if not all(ai.can_bases == can_bases for ai in all_ai):
        sys.exit("All canonical alphabets must be the same. Got: {}".format(
            ", ".join(sorted(set(ai.can_bases for ai in all_ai)))))
    # mod letter -> (canonical base, long name)
    mods = {}
    for fn, ai in zip(in_fns, all_ai):
        for b, can_b in zip(ai.alphabet, ai.collapse_alphabet):
            if b in ai.can_bases_set:
                continue
            entry = (can_b, ai.mod_name_conv[b])
            if b in mods and mods[b] != entry:
                sys.exit(
                    "Incompatible mod base {}: {} vs {}".format(
                        b, mods[b], entry))
            if entry[1] in [v[1] for k, v in mods.items() if k != b]:
                sys.exit("Mod long name {} used for multiple codes".format(
                    entry[1]))
            mods[b] = entry
    alphabet = can_bases + "".join(sorted(mods))
    collapse = can_bases + "".join(mods[b][0] for b in sorted(mods))
    long_names = [mods[b][1] for b in sorted(mods)]
    return AlphabetInfo(alphabet, collapse, long_names, do_reorder=True)


def label_conversion(src_ai, dst_ai):
    """Per-label conversion table from a source alphabet to the merged."""
    table = np.zeros(src_ai.nbase, dtype=np.int16)
    for i, b in enumerate(src_ai.alphabet):
        table[i] = dst_ai.alphabet.index(b)
    return table


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.seed is not None:
        np.random.seed(args.seed)
    in_fns = [fn for fn, _ in args.input]
    limits = [None if n == "None" else int(n) for _, n in args.input]

    if args.allow_mod_merge:
        out_ai = merge_alphabets(in_fns)
    else:
        with open_checked(in_fns[0]) as msr:
            out_ai = msr.get_alphabet_information()
        for fn in in_fns[1:]:
            with open_checked(fn) as msr:
                if not msr.get_alphabet_information().equals(out_ai):
                    sys.exit(
                        "Alphabets do not match (pass --allow_mod_merge "
                        "to merge modified-base alphabets): {}".format(fn))

    sys.stderr.write("* Merged alphabet: {}\n".format(out_ai))
    n_written = n_dup = 0
    seen = set()
    with MappedSignalWriter(args.output, out_ai,
                            args.batch_format) as msw:
        for fn, limit in zip(in_fns, limits):
            with open_checked(fn,
                              load_in_mem=args.load_in_mem) as msr:
                src_ai = msr.get_alphabet_information()
                conv = (label_conversion(src_ai, out_ai)
                        if args.allow_mod_merge else None)
                read_ids = msr.get_read_ids()
                # ids already written are left out before the limit is
                # applied, so duplicates do not eat into a file's count
                n_dup += sum(1 for rid in read_ids if rid in seen)
                read_ids = [rid for rid in read_ids if rid not in seen]
                if limit is not None and limit < len(read_ids):
                    read_ids = list(np.random.choice(
                        read_ids, limit, replace=False))
                for read in msr.reads(read_ids):
                    seen.add(read.read_id)
                    rd = read.get_read_dictionary()
                    if conv is not None:
                        rd["Reference"] = conv[rd["Reference"]]
                    msw.write_read(rd)
                    n_written += 1
    if n_dup:
        sys.stderr.write("* Skipped {} duplicate read ids\n".format(n_dup))
    sys.stderr.write("* Wrote {} reads to {}\n".format(
        n_written, args.output))


if __name__ == "__main__":
    main()
