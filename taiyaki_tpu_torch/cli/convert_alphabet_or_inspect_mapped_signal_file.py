"""Convert (or print) the alphabet attributes of a mapped-signal file
(port of misc/convert_alphabet_or_inspect_mapped_signal_file.py; host
only, no device).

    python -m taiyaki_tpu_torch.cli.convert_alphabet_or_inspect_mapped_signal_file \\
        mapped.hdf5 [--print_only] [--print_read_total] \\
        [--can_base_convert A X] [--mod_base_convert Z Y] \\
        [--mod_long_name_convert 5mC methylC]

The attributes are changed in place (mod to canonical associations cannot
be changed here): through h5py "r+" where h5py is installed, else by
rewriting the file through the port's data/hdf5.py
(`mapped_signal_files.edit_in_place`: the same datasets and attributes,
other bytes).
"""

import argparse
import re
import sys

from taiyaki_tpu_torch.data.mapped_signal_files import (
    MappedSignalReader, edit_in_place)


def get_parser():
    parser = argparse.ArgumentParser(
        description="Convert (or print) alphabet attributes contained "
                    "within a mapped signal file.")
    parser.add_argument("input", help="Mapped-signal HDF5 to operate on.")
    parser.add_argument("--print_only", action="store_true",
                        help="Only print the alphabet information.")
    parser.add_argument("--print_read_total", action="store_true",
                        help="Print the number of reads in this file.")
    parser.add_argument("--can_base_convert", nargs=2, default=[],
                        action="append",
                        help="Current and new single-letter canonical base")
    parser.add_argument("--mod_base_convert", nargs=2, default=[],
                        action="append",
                        help="Current and new single-letter modified base")
    parser.add_argument("--mod_long_name_convert", nargs=2, default=[],
                        action="append",
                        help="Current and new modified base long names")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    with MappedSignalReader(args.input) as msr:
        ai = msr.get_alphabet_information()
        n_reads = len(msr.get_read_ids()) if args.print_read_total else None
    sys.stderr.write('File, "{}", currently contains: {}\n'.format(
        args.input, ai))
    if args.print_read_total:
        sys.stderr.write('File, "{}", contains {} total reads\n'.format(
            args.input, n_reads))
    if args.print_only:
        sys.exit()

    alphabet = list(ai.alphabet)
    collapse = list(ai.collapse_alphabet)
    long_names = list(ai.mod_long_names)

    for curr, new in args.can_base_convert:
        assert len(curr) == 1 and len(new) == 1, (
            "Single letter codes must be a single character")
        if curr not in ai.can_bases_set:
            sys.exit("Specified current canonical base ({}) not found in "
                     "file.".format(curr))
        alphabet[ai.alphabet.index(curr)] = new
        for m in re.finditer(curr, ai.collapse_alphabet):
            collapse[m.start()] = new
    for curr, new in args.mod_base_convert:
        assert len(curr) == 1 and len(new) == 1, (
            "Single letter codes must be a single character")
        if curr not in ai.mod_bases_set:
            sys.exit("Specified current modified base ({}) not found in "
                     "file.".format(curr))
        alphabet[ai.alphabet.index(curr)] = new
    # renames go against the original names: chained conversions do not
    # see each other's results, and the attribute is newline-joined, so a
    # new name holds no newline
    orig_long_names = list(ai.mod_long_names)
    for curr, new in args.mod_long_name_convert:
        assert "\n" not in new, (
            "Modified base long names cannot contain newlines")
        if curr not in orig_long_names:
            sys.exit("Specified current long name ({}) not found in "
                     "file.".format(curr))
        long_names[orig_long_names.index(curr)] = new

    if not (args.can_base_convert or args.mod_base_convert
            or args.mod_long_name_convert):
        sys.exit("No new alphabet information provided.")

    def edit(h5):
        h5.attrs["alphabet"] = "".join(alphabet)
        h5.attrs["collapse_alphabet"] = "".join(collapse)
        h5.attrs["mod_long_names"] = "\n".join(long_names)

    edit_in_place(args.input, edit)
    sys.stderr.write("Updated alphabet to {} (collapse {})\n".format(
        "".join(alphabet), "".join(collapse)))


if __name__ == "__main__":
    main()
