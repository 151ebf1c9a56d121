"""Predict expected current (squiggle) from sequence (port of
bin/predict_squiggle.py).

    python -m taiyaki_tpu_torch.cli.predict_squiggle [options] \\
        model.checkpoint sequences.fa

For each sequence of the fasta, the network's forward (on --device, the
card by default) gives each base's (level, log scale, rate); the output
is the JAX CLI's TSV: a header, then per base its current, sd =
exp(log scale) and dwell = exp(-rate), as float32 text.  f32 throughout
(TF32 off).
"""

import argparse
import sys

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import FileExists
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Predict squiggle from sequence",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, "device output version".split())
    parser.add_argument("model", action=FileExists, help="Squiggle-model checkpoint")
    parser.add_argument("input", action=FileExists, help="Fasta of sequences to predict from")
    return parser


def load_squiggle_model(model, device):
    """The network of a squiggle checkpoint with its weights, on `device`,
    in eval mode; exits if `model` holds no weights."""
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    net, params, *_ = helpers.load_model(model)
    if params is None:
        sys.exit("* Error: pass a trained .checkpoint")
    return load_jax_params(net, params).to(device).eval()


def predict(net, seq):
    """The squiggle of base string `seq`: [len(seq), 3] float32 numpy
    (level, log scale, rate)."""
    import torch
    from taiyaki_tpu_torch.ops.squiggle import embed_sequence
    dev = next(net.parameters()).device
    with torch.no_grad():
        embedded = torch.from_numpy(embed_sequence(seq)[:, None, :])
        return net(embedded.to(dev))[:, 0, :].cpu().numpy()


def main(argv=None):
    args = get_parser().parse_args(argv)
    import torch
    from taiyaki_tpu_torch.bio import iter_fasta
    from taiyaki_tpu_torch.cli.basecall import select_device
    from taiyaki_tpu_torch.utils import helpers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = load_squiggle_model(args.model, select_device(args.device))

    with helpers.open_file_or_stdout(args.output) as fh:
        with open(args.input) as in_fh:
            for _, seq in iter_fasta(in_fh):
                squiggle = predict(net, seq)
                fh.write("base\tcurrent\tsd\tdwell\n")
                for base, (mean, logsd, dwell) in zip(seq, squiggle):
                    fh.write("{}\t{}\t{}\t{}\n".format(
                        base, mean, np.exp(logsd), np.exp(-dwell)))


if __name__ == "__main__":
    main()
