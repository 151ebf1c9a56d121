"""Upgrade a mapped-signal file to the current format version (port of
misc/upgrade_mapped_signal.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.upgrade_mapped_signal v7.hdf5 v8.hdf5

v7 to v8: the per-read alphabet attributes become the root's, and an
empty mod_long_names is added.  The input is copied to the output, which
is then edited in place: through h5py "r+" where h5py is installed, else
by rewriting it through the port's data/hdf5.py
(`mapped_signal_files.edit_in_place`: the same datasets and attributes,
other bytes).
"""

import argparse
import logging
from shutil import copyfile

from taiyaki_tpu_torch.data.mapped_signal_files import edit_in_place
from taiyaki_tpu_torch.utils.cmdargs import FileAbsent, FileExists
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Upgrade mapped signal HDF5 file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, ["version"])
    parser.add_argument("input", action=FileExists,
                        help="Source mapped-signal HDF5")
    parser.add_argument("output", action=FileAbsent,
                        help="Destination path for the upgraded HDF5")
    return parser


def convert_7_to_8(h5):
    """v7 -> v8: hoist the per-read alphabet attributes to the root; add
    mod_long_names."""
    input_version = h5.attrs["version"]
    if input_version > 7:
        return
    if input_version < 7:
        logging.error("Input version expected to be 7, got {}".format(
            input_version))
        return
    print("Upgrading to version 8")
    first_read = next(iter(h5["Reads"]))
    read0 = h5["Reads"][first_read]
    h5.attrs["alphabet"] = read0.attrs["alphabet"]
    h5.attrs["collapse_alphabet"] = read0.attrs["collapse_alphabet"]
    h5.attrs["mod_long_names"] = ""
    for read in h5["Reads"]:
        rh = h5["Reads"][read]
        del rh.attrs["alphabet"]
        del rh.attrs["collapse_alphabet"]
    h5.attrs["version"] = 8


def main(argv=None):
    args = get_parser().parse_args(argv)
    copyfile(args.input, args.output)
    edit_in_place(args.output, convert_7_to_8)


if __name__ == "__main__":
    main()
