"""Print the tree of an HDF5 file (port of misc/check_hdf5_contents.py;
host only, no device).

    python -m taiyaki_tpu_torch.cli.check_hdf5_contents file.hdf5

Prints the root's attributes, then every group and dataset below it in
name order, depth first: a dataset's shape and dtype, a group's
attributes where it has any.  The file is read through h5py where it is
installed, else through the port's data/hdf5.py; the listing is the
same either way.
"""

import argparse
import sys

from taiyaki_tpu_torch.data import hdf5


def get_parser():
    parser = argparse.ArgumentParser(
        description="List contents of an HDF5 file")
    parser.add_argument("input", help="HDF5 file to inspect")
    return parser


def _visit(group, prefix, show):
    """show(name, node) for every member below `group`, in name order,
    each group before its members (h5py's visititems order)."""
    for key in sorted(group.keys()):
        node = group[key]
        name = prefix + key
        show(name, node)
        if not hasattr(node, "dtype"):
            _visit(node, name + "/", show)


def main(argv=None):
    args = get_parser().parse_args(argv)
    with hdf5.open_file(args.input) as f:
        print("Root attrs:", dict(f.attrs))

        def show(name, obj):
            if hasattr(obj, "dtype"):
                print("{}  dataset shape={} dtype={}".format(
                    name, obj.shape, obj.dtype))
            else:
                attrs = dict(obj.attrs)
                print("{}/  group{}".format(
                    name, " attrs=" + str(attrs) if attrs else ""))

        _visit(f, "", show)
    return 0


if __name__ == "__main__":
    sys.exit(main())
