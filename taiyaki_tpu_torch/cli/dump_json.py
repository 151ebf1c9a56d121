"""Dump a Guppy-loadable JSON representation of a model (port of
bin/dump_json.py).

    python -m taiyaki_tpu_torch.cli.dump_json [--output model.json] model.checkpoint

Reads a checkpoint of either package, puts its weights into the port's
network and writes the network's `json()` with the checkpoint's md5sum,
indented by 4, as bin/dump_json.py writes it: the same bytes for the same
checkpoint.  No arithmetic runs, so no device is used: the weights are
read on the host.
"""

import argparse
import json
import sys

from taiyaki_tpu_torch.utils.cmdargs import FileExists
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Dump JSON representation of model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, ["output"])
    parser.add_argument("model", action=FileExists,
                        help="Checkpoint file to export")
    return parser


def main(argv=None):
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils.helpers import (
        file_md5, load_model, open_file_or_stdout)
    from taiyaki_tpu_torch.utils.json import JsonEncoder
    args = get_parser().parse_args(argv)
    model_md5 = file_md5(args.model)
    net, params, _, _, _, _ = load_model(args.model)
    if params is None:
        sys.exit("* Error: {} has no parameters (pass a .checkpoint)"
                 .format(args.model))
    json_out = load_jax_params(net, params).json()
    json_out["md5sum"] = model_md5
    with open_file_or_stdout(args.output) as fh:
        json.dump(json_out, fh, indent=4, cls=JsonEncoder)


if __name__ == "__main__":
    main()
