"""Train a squiggle predictor, sequence -> expected current (port of
bin/train_squiggle.py).

    python -m taiyaki_tpu_torch.cli.train_squiggle [options] mapped.hdf5

The network is a stack of convolutions (`create_convolution`) from each
base's tetrahedron embedding to its (level, log scale, rate); the loss of
a batch is the squiggle-match cost (`ops.squiggle.squiggle_match_cost`)
summed over its real chunks over their summed signal lengths.  Chunks of
--target_len bases are sampled as the JAX CLI samples them (one --seed
draws the same weights and chunks in both), padded to a fixed signal
length and batch size; AdamW with the learning rate
lr_max * lr_decay / (i + lr_decay) at step i.  Checkpoints go to --outdir
in the JAX package's format.  --device defaults to the card; --device
cpu runs on the CPU.  f32 throughout (TF32 off).
"""

import argparse
import os
import sys
import time
from collections import defaultdict
from itertools import islice

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import (
    AutoBool, FileExists, Maybe, Positive, proportion)
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Train a model to predict ionic current levels from "
                    "sequence",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(
        parser, """adam device eps filter_max_dwell filter_mean_dwell limit
        niteration outdir overwrite quiet reverse save_every
        sample_nreads_before_filtering version weight_decay""".split())
    parser.add_argument(
        "--batch_size", default=100, metavar="chunks", type=Positive(int),
        help="Chunks per training batch")
    parser.add_argument(
        "--back_prob", default=1e-15, metavar="probability",
        type=proportion, help="Chance of a backward step in the alignment")
    parser.add_argument(
        "--depth", metavar="layers", default=4, type=Positive(int),
        help="Depth of the residual convolution stack")
    parser.add_argument(
        "--filter_path_buffer", default=1.1, metavar="ratio", type=float,
        help="Drop chunks with small ratio of signal length to bases")
    parser.add_argument(
        "--filter_min_pass_fraction", default=0.5, metavar="fraction",
        type=Maybe(Positive(float)),
        help="Abort when the chunk-filter pass rate falls below this fraction")
    parser.add_argument(
        "--full_filter_status", default=False, action=AutoBool,
        help="Output full chunk filtering statistics.")
    parser.add_argument(
        "--input_strand_list", default=None, action=FileExists,
        help="Strand summary file containing column read_id.")
    parser.add_argument(
        "--lr_decay", default=5000, metavar="n", type=Positive(float),
        help="Decay scale n: batch i trains at lr_max / (1 + i/n)")
    parser.add_argument(
        "--lr_max", default=1.0e-4, metavar="rate", type=Positive(float),
        help="Learning rate at step 0 (the maximum)")
    parser.add_argument(
        "--seed", default=None, metavar="integer", type=Positive(int),
        help="Seed for all RNGs (parameter init and data order)")
    parser.add_argument(
        "--size", metavar="n", default=32, type=Positive(int),
        help="Channels per convolution layer")
    parser.add_argument(
        "--target_len", metavar="n", default=300, type=Positive(int),
        help="Sequence length to cut references into")
    parser.add_argument(
        "--winlen", metavar="n", default=9, type=Positive(int),
        help="Convolution kernel width")
    parser.add_argument(
        "input", action=FileExists, help="Mapped-signal HDF5 with the training data")
    return parser


def create_convolution(size, depth, winlen):
    """Conv(3->size) + depth residual convs + Conv(size->3)."""
    from taiyaki_tpu_torch import activation, layers
    return layers.Serial(
        [layers.Convolution(3, size, winlen, stride=1, fun=activation.tanh)]
        + [layers.Residual(layers.Convolution(size, size, winlen, stride=1,
                                              fun=activation.tanh))
           for _ in range(depth)]
        + [layers.Convolution(size, 3, winlen, stride=1,
                              fun=activation.linear)])


# the model source a checkpoint stores: the JAX CLI's text, byte for byte,
# so that either package's checkpoint loads in the other
MODEL_SOURCE_TMPL = """\
from taiyaki_tpu import activation, layers


def network(size={size}, depth={depth}, winlen={winlen}, **kwargs):
    return layers.Serial(
        [layers.Convolution(3, size, winlen, stride=1, fun=activation.tanh)]
        + [layers.Residual(layers.Convolution(
               size, size, winlen, stride=1, fun=activation.tanh))
           for _ in range({depth})]
        + [layers.Convolution(size, 3, winlen, stride=1,
                              fun=activation.linear)])
"""


def max_signal_length(target_len, filter_params, filter_mean_dwell):
    """The fixed padded signal length of every batch: target_len bases at
    the largest mean dwell the filter passes (with the filter off, 10
    MADs above the median), rounded up to a multiple of 256."""
    dwell_mads = 10.0 if filter_mean_dwell is None else filter_mean_dwell
    max_dwell = (filter_params.median_meandwell
                 + dwell_mads * filter_params.mad_meandwell)
    return int(np.ceil(target_len * max_dwell / 256.0)) * 256


def make_batch(chunks, target_len, max_siglen, batch_size, reverse=False):
    """Chunks as padded arrays: the sequences' embeddings [target_len, B,
    3], signals [max_siglen, B], signal lengths [B] and weights [B], B =
    batch_size.  A short batch is filled with repeats of its chunks, of
    weight 0."""
    from taiyaki_tpu_torch.ops.squiggle import embed_sequence
    revop = np.flip if reverse else np.asarray
    n = len(chunks)
    seq_embed = np.zeros((target_len, n, 3), dtype=np.float32)
    signals = np.zeros((max_siglen, n), dtype=np.float32)
    siglens = np.zeros(n, dtype=np.int32)
    for j, chunk in enumerate(chunks):
        seq_embed[:, j] = embed_sequence(revop(chunk.sequence),
                                         alphabet=None)
        signals[:chunk.sig_len, j] = revop(chunk.current)
        siglens[j] = chunk.sig_len
    valid = np.ones(batch_size, dtype=np.float32)
    if n < batch_size:
        reps = [j % n for j in range(batch_size - n)]
        seq_embed = np.concatenate([seq_embed, seq_embed[:, reps]], 1)
        signals = np.concatenate([signals, signals[:, reps]], 1)
        siglens = np.concatenate([siglens, siglens[reps]])
        valid[n:] = 0.0
    return seq_embed, signals, siglens, valid


def batch_loss(net, batch, back_prob):
    """The loss of a batch of tensors (make_batch's, on net's device): the
    weighted sum of the squiggle-match costs over the weighted sum of the
    signal lengths."""
    from taiyaki_tpu_torch.ops.squiggle import squiggle_match_cost
    seq_embed, signals, siglens, valid = batch
    costs = squiggle_match_cost(net(seq_embed), signals, siglens, back_prob)
    return (costs * valid).sum() / (siglens.float() * valid).sum()


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "max_siglen", "device"}
    of the training loop (a step's seconds synchronised with the card)."""
    args = get_parser().parse_args(argv)
    import torch
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.cli.basecall import select_device
    from taiyaki_tpu_torch.constants import DOTROWLENGTH, MODEL_LOG_FILENAME
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    from taiyaki_tpu_torch.data.signal_mapping import Chunk
    from taiyaki_tpu_torch.utils import helpers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = select_device(args.device)

    seed = np.random.randint(2 ** 31) if args.seed is None else args.seed
    np.random.seed(seed)
    rng = np.random.default_rng(seed)

    helpers.prepare_outdir(args.outdir, args.overwrite)
    log = helpers.Logger(os.path.join(args.outdir, MODEL_LOG_FILENAME),
                         args.quiet)
    log.write(helpers.formatted_env_info(device))

    with mapped_signal_files.MappedSignalReader(args.input) as msr:
        alphabet_info = msr.get_alphabet_information()
        if alphabet_info.nbase != 4:
            sys.exit("* Error: squiggle prediction with modified base "
                     "training data is not supported.")
        if args.input_strand_list is not None:
            from taiyaki_tpu_torch.utils.fileio import readtsv
            read_ids = list(readtsv(args.input_strand_list,
                                    ["read_id"])["read_id"])
            log.write("* Will train from a subset of {} strands\n".format(
                len(read_ids)))
        else:
            read_ids = None
        read_data = list(islice(msr.reads(read_ids), args.limit))
    if len(read_data) == 0:
        log.write("* No reads remaining for training, exiting.\n")
        sys.exit(1)
    log.write("* Loaded {} reads.\n".format(len(read_data)))

    filter_params = chunk_selection.sample_filter_parameters(
        read_data, args.sample_nreads_before_filtering, args.target_len,
        args.filter_mean_dwell, args.filter_max_dwell,
        args.filter_min_pass_fraction, 1, args.filter_path_buffer,
        chunk_len_means_sequence_len=True)
    log.write("* Sampled chunks: median(mean_dwell)={:.2f}, "
              "mad(mean_dwell)={:.2f}\n".format(
                  filter_params.median_meandwell,
                  filter_params.mad_meandwell))

    net = create_convolution(args.size, args.depth, args.winlen)
    net = load_jax_params(net, net.init(rng)).to(device).train()
    model_source = MODEL_SOURCE_TMPL.format(
        size=args.size, depth=args.depth, winlen=args.winlen)
    metadata = {"reverse": args.reverse, "standardize": True, "version": 3}
    log.write("* Created network.\n* Depth {} layers ({} residual layers)\n"
              "* Window width {}\n".format(args.depth + 2, args.depth,
                                           args.winlen))
    max_siglen = max_signal_length(args.target_len, filter_params,
                                   args.filter_mean_dwell)

    params = train.leaf_params(net)
    optimizer = train.Optimizer(
        params, lambda i: args.lr_max * args.lr_decay / (i + args.lr_decay),
        lambda i: args.adam[0], args.adam[1], args.eps, args.weight_decay)

    score_smoothed = helpers.WindowedExpSmoother()
    rejection_dict = defaultdict(int)
    losses, step_seconds = [], []
    t0 = time.time()
    log.write("* Training\n")
    for i in range(args.niteration):
        chunk_batch, rejections = chunk_selection.sample_chunks(
            read_data, args.batch_size, args.target_len, filter_params,
            chunk_len_means_sequence_len=True)
        for k, v in rejections.items():
            rejection_dict[k] += v
        chunk_batch = [c for c in chunk_batch if c.sig_len <= max_siglen]
        if len(chunk_batch) == 0:
            log.write("* Warning: no usable chunks this iteration\n")
            continue
        t_step = time.time()
        batch = [torch.from_numpy(a).to(device) for a in make_batch(
            chunk_batch, args.target_len, max_siglen, args.batch_size,
            args.reverse)]
        loss = batch_loss(net, batch, args.back_prob)
        optimizer.step(torch.autograd.grad(loss, params))
        loss = float(loss.detach())
        step_seconds.append(time.time() - t_step)
        losses.append(loss)
        score_smoothed.update(loss)

        if (i + 1) % args.save_every == 0:
            helpers.save_model(args.outdir, net, params_to_jax(net),
                               model_source, {}, metadata,
                               (i + 1) // args.save_every)
            log.write("C")
        else:
            log.write(".")
        if (i + 1) % DOTROWLENGTH == 0:
            dt = time.time() - t0
            log.write(" {:5d} {:7.5f}  {:5.2f}s".format(
                (i + 1) // DOTROWLENGTH, score_smoothed.value, dt))
            n_tot = sum(rejection_dict.values())
            n_fail = n_tot - rejection_dict[Chunk.rej_str_pass]
            if args.full_filter_status:
                for k, v in rejection_dict.items():
                    log.write(" {}:{} ".format(k, v))
            else:
                log.write("  {:.1%} chunks filtered".format(
                    n_fail / max(n_tot, 1)))
            log.write("\n")
            t0 = time.time()

    helpers.save_model(args.outdir, net, params_to_jax(net), model_source,
                       {}, metadata)
    log.close()
    return dict(losses=losses, step_seconds=step_seconds,
                max_siglen=max_siglen, device=str(device))


if __name__ == "__main__":
    main()
