"""Ab-initio (bootstrap) training of a flip-flop network from fixed-length
chunks and their sequences (port of bin/train_abinitio.py).

    python -m taiyaki_tpu_torch.cli.train_abinitio [options] \\
        model.py chunks.hdf5 references.fa

`chunks.hdf5` holds a [nchunk, chunk_len] dataset "chunks" (read through
h5py, or the port's `data/hdf5.py` where h5py is absent); the fasta holds
chunk i's sequence under the name "i", converted to flip-flop codes and
cached beside it as a .pkl (a .pkl given instead is loaded).  Each
iteration draws --batch_size chunks with numpy's global state after
np.random.seed(--seed), as the JAX CLI draws them, pads the sequences to
the dataset's longest, and takes one step: the flip-flop training loss
(`train.make_loss_fn`: the network's kernels, the CRF loss and logZ, no
sharpening), the gradient scaled to a global L2 norm of at most the
rolling quantile cap, and AdamW with a cosine decay of the learning rate
from --lr_max to 0 over --niteration.  The logs and checkpoints are the
JAX CLI's.  --device defaults to the card; --device cpu runs the
kernels' plain twins.  f32 throughout (TF32 off).
"""

import argparse
import os
import pickle
import time
from shutil import copyfile

import numpy as np

from taiyaki_tpu_torch.utils.cmdargs import (
    FileExists, Maybe, NonNegative, Positive)
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Train a flip-flop neural network ab initio",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(
        parser, """adam alphabet device eps limit niteration outdir
        overwrite quiet save_every version weight_decay""".split())
    parser.add_argument(
        "--batch_size", default=128, metavar="chunks", type=Positive(int),
        help="Chunks per training batch")
    parser.add_argument(
        "--gradient_cap_fraction", default=0.05, metavar="f",
        type=Maybe(NonNegative(float)),
        help="Bound the gradient L2 norm so that a fraction f of steps "
             "are capped. Use None for no capping.")
    parser.add_argument(
        "--lr_max", default=4.0e-3, metavar="rate", type=Positive(float),
        help="Learning rate at step 0")
    parser.add_argument(
        "--size", default=96, metavar="neurons", type=Positive(int),
        help="Width (hidden units) of the network layers")
    parser.add_argument(
        "--seed", default=None, metavar="integer", type=Positive(int),
        help="Seed for all RNGs (parameter init and data order)")
    parser.add_argument(
        "--stride", default=2, metavar="samples", type=Positive(int),
        help="Downsampling stride of the convolution front end")
    parser.add_argument(
        "--winlen", default=19, type=Positive(int),
        help="Convolution front-end window width in samples")
    parser.add_argument("model", action=FileExists,
                        help="Python file defining the network to train")
    parser.add_argument("chunks", action=FileExists,
                        help="HDF5 of fixed-length signal chunks")
    parser.add_argument("reference", action=FileExists,
                        help="fasta of the per-chunk sequences")
    return parser


def convert_seq(s, alphabet):
    """Sequence string -> flip-flop codes."""
    from taiyaki_tpu_torch import flipflopfings
    lut = {b: i for i, b in enumerate(alphabet)}
    buf = np.array([lut[b] for b in s], dtype=np.int32)
    return flipflopfings.flipflop_code(buf, len(alphabet))


def read_chunks(path, limit=None):
    """The first `limit` (all for None) rows of the "chunks" dataset."""
    from taiyaki_tpu_torch.data import hdf5
    h5 = hdf5.open_file(path)
    try:
        return np.asarray(h5["chunks"][:limit])
    finally:
        h5.close()


def make_batch(chunks, seq_dict, idx, max_seqlen):
    """The training Batch (numpy) of the chunks `idx`: signal [chunk_len,
    B, 1] f32, flip-flop codes padded to max_seqlen, sequence lengths."""
    from taiyaki_tpu_torch import train
    indata = chunks[idx].T[..., np.newaxis].astype(np.float32)
    seqs = np.zeros((len(idx), max_seqlen), dtype=np.int32)
    seqlens = np.zeros(len(idx), dtype=np.int32)
    for j, ci in enumerate(idx):
        s = seq_dict[ci]
        seqs[j, :len(s)] = s
        seqlens[j] = len(s)
    return train.Batch(indata, seqs, seqlens, None)


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "device"} of the training
    loop (a step's seconds synchronised with the card)."""
    args = get_parser().parse_args(argv)
    import torch
    from taiyaki_tpu_torch import alphabet as alphabet_mod
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.bio import iter_fasta
    from taiyaki_tpu_torch.cli.basecall import select_device
    from taiyaki_tpu_torch.constants import MODEL_LOG_FILENAME
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.maths import RollingQuantile
    from taiyaki_tpu_torch.utils import helpers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = select_device(args.device)

    np.random.seed(args.seed)
    rng = np.random.default_rng(args.seed)
    helpers.prepare_outdir(args.outdir, args.overwrite)
    copyfile(args.model, os.path.join(args.outdir, "model.py"))
    log = helpers.Logger(os.path.join(args.outdir, MODEL_LOG_FILENAME),
                         args.quiet)
    log.write(helpers.formatted_env_info(device))
    log.write("* Loading data from {}\n".format(args.chunks))
    log.write("* Per read file MD5 {}\n".format(helpers.file_md5(
        args.chunks)))

    chunks = read_chunks(args.chunks, args.limit)
    log.write("* Loaded {} chunks from {}.\n".format(len(chunks),
                                                     args.chunks))

    if os.path.splitext(args.reference)[1] == ".pkl":
        with open(args.reference, "rb") as fh:
            seq_dict = pickle.load(fh)
        log.write("* Loaded preprocessed references from {}.\n".format(
            args.reference))
    else:
        with open(args.reference) as fh:
            seq_dict = {int(name): convert_seq(seq, args.alphabet)
                        for name, seq in iter_fasta(fh)}
        log.write("* Loaded references from {}.\n".format(args.reference))
        pickle_name = os.path.splitext(args.reference)[0] + ".pkl"
        with open(pickle_name, "wb") as fh:
            pickle.dump(seq_dict, fh)
        log.write("* Written pickle of processed references to {} for "
                  "future use.\n".format(pickle_name))

    log.write("* Reading network from {}\n".format(args.model))
    alphabet_info = alphabet_mod.AlphabetInfo(args.alphabet, args.alphabet)
    model_kwargs = {"size": args.size, "stride": args.stride,
                    "winlen": args.winlen, "insize": 1,
                    "alphabet_info": alphabet_info}
    metadata = {"reverse": False, "standardize": True}
    net, params, model_source, metadata, model_kwargs, _ = \
        helpers.load_model(args.model, model_metadata=metadata,
                           **model_kwargs)
    if params is None:
        params = net.init(rng)
    net = load_jax_params(net, params).to(device).train()
    params = train.leaf_params(net)

    # optax.cosine_decay_schedule(lr_max, niteration): lr_max down to 0
    schedule = train.make_schedule(args.lr_max, args.niteration, 0, None,
                                   0.0)
    optimizer = train.Optimizer(params, schedule, lambda count: args.adam[0],
                                args.adam[1], args.eps, args.weight_decay)

    # static padded sequence length across the dataset
    max_seqlen = max(len(s) for s in seq_dict.values())
    loss_fn = train.make_loss_fn(net)

    score_smoothed = helpers.WindowedExpSmoother()
    log.write("* Dumping initial model\n")
    helpers.save_model(args.outdir, net, params_to_jax(net), model_source,
                       model_kwargs, metadata, 0)

    grad_cap = 1e30
    rolling_quantile = None
    if args.gradient_cap_fraction is None:
        log.write("* No gradient capping\n")
    else:
        rolling_quantile = RollingQuantile(args.gradient_cap_fraction)
        log.write("* Gradient L2 norm cap will be upper {:3.2f} quantile "
                  "of the last {} norms.\n".format(
                      args.gradient_cap_fraction, rolling_quantile.window))

    total_bases = total_samples = 0
    losses, step_seconds = [], []
    t0 = time.time()
    log.write("* Training\n")
    for i in range(args.niteration):
        idx = np.random.choice(len(chunks), size=args.batch_size,
                               replace=False)
        batch = make_batch(chunks, seq_dict, idx, max_seqlen)
        t_step = time.time()
        loss = loss_fn(train.batch_to_device(batch, device), 1.0, 1.0)
        grads = torch.autograd.grad(loss, params)
        # global L2 norm cap at the rolling quantile of recent norms
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = torch.clamp(grad_cap / (gnorm + 1e-6), max=1.0)
        optimizer.step([g * scale for g in grads])
        gnorm, loss = float(gnorm), float(loss.detach())
        step_seconds.append(time.time() - t_step)
        if rolling_quantile is not None:
            grad_cap = rolling_quantile.update(gnorm)
        losses.append(loss)
        score_smoothed.update(loss)
        total_bases += int(batch.seqlens.sum())
        total_samples += batch.signal.size

        if (i + 1) % args.save_every == 0:
            helpers.save_model(args.outdir, net, params_to_jax(net),
                               model_source, model_kwargs, metadata,
                               (i + 1) // args.save_every)
            log.write("C")
        else:
            log.write(".")
        if (i + 1) % 50 == 0:
            dt = time.time() - t0
            log.write(
                " {:5d} {:7.5f}  {:5.2f}s ({:.2f} ksample/s {:.2f} "
                "kbase/s) lr={:.2e}\n".format(
                    (i + 1) // 50, score_smoothed.value, dt,
                    total_samples / 1000.0 / dt, total_bases / 1000.0 / dt,
                    float(schedule(i))))
            total_bases = total_samples = 0
            t0 = time.time()

    helpers.save_model(args.outdir, net, params_to_jax(net), model_source,
                       model_kwargs, metadata)
    log.close()
    return dict(losses=losses, step_seconds=step_seconds, device=str(device))


if __name__ == "__main__":
    main()
