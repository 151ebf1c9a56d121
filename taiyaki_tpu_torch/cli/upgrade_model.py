"""Upgrade a model checkpoint to the current MODEL_VERSION (port of
misc/upgrade_model.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.upgrade_model old.checkpoint new.checkpoint

Checkpoints of this format have versions from 3 on; the reference's v0-v2
formats are torch pickles, which `cli.import_torch_checkpoint` converts
(and stamps with the current version), and this tool refuses them with a
message naming it.  The checkpoint is read with the port's restricted
unpickler and written back with optax's classes named as optax's, as
`utils.helpers.save_model` writes them, so the JAX package reads it.
"""

import argparse
import pickle
import sys

from taiyaki_tpu_torch import MODEL_VERSION
from taiyaki_tpu_torch.utils.cmdargs import FileAbsent, FileExists
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args
from taiyaki_tpu_torch.utils.helpers import _CheckpointPickler, _unpickle


def get_parser():
    parser = argparse.ArgumentParser(
        description="Upgrade a model checkpoint to the current version",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, ["version"])
    parser.add_argument("input", action=FileExists,
                        help="Model checkpoint to upgrade")
    parser.add_argument("output", action=FileAbsent,
                        help="Upgraded model checkpoint")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    try:
        ckpt = _unpickle(args.input)
    except Exception as e:
        sys.exit(
            "Could not read {} as a taiyaki_tpu checkpoint ({}).\n"
            "If this is a reference (torch) checkpoint, use "
            "python -m taiyaki_tpu_torch.cli.import_torch_checkpoint "
            "instead.".format(args.input, e))
    if not isinstance(ckpt, dict) or "metadata" not in ckpt:
        sys.exit("Not a taiyaki_tpu checkpoint; use python -m "
                 "taiyaki_tpu_torch.cli.import_torch_checkpoint for torch "
                 "checkpoints.")
    version = ckpt["metadata"].get("version")
    if version == MODEL_VERSION:
        print("Model already at version {}".format(MODEL_VERSION))
    else:
        print("Upgrading model from version {} to {}".format(
            version, MODEL_VERSION))
        ckpt["metadata"]["version"] = MODEL_VERSION
        ckpt["metadata"].setdefault("reverse", False)
        ckpt["metadata"].setdefault("standardize", True)
    with open(args.output, "wb") as fh:
        _CheckpointPickler(fh, pickle.DEFAULT_PROTOCOL).dump(ckpt)
    print("Wrote", args.output)


if __name__ == "__main__":
    main()
