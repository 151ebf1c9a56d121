"""Train a flip-flop basecaller on an NVIDIA card (port of
bin/train_flipflop.py).

    python -m taiyaki_tpu_torch.cli.train_flipflop [options] model input.hdf5

`model` is a model description (.py) or a checkpoint to start from;
`input` a mapped-signal file.  The options, the seeds and the order of
every random draw are those of bin/train_flipflop.py, so one --seed
draws the same initial weights, validation reads and chunks in both.
Each iteration samples a batch (on a prefetch thread, one iteration
ahead), runs one training step (`train.make_train_step`: LSTM, CRF and
logZ kernels forward and backward, clip, AdamW) and logs it.  A cat_mod
model (a GlobalNormFlipFlopCatMod head) trains on the mapped reads' mod
labels with the cat_mod loss, its mod weights (1, or the log-odds priors
of --mod_prior_factor) scaled per iteration by the --mod_factor ramp.
With --multihost this process is one rank of a data-parallel job, one
process per card (`parallel.mesh.start`; the rendezvous from
$TAIYAKI_COORDINATOR, $TAIYAKI_NUM_PROCS and $TAIYAKI_PROC_ID, or
torchrun's variables): every rank draws its share of each sub-batch from
seed + rank, the sequence padding and the count of real rows are agreed
on a gloo group of their own (`utils.hostsync`), and each step sums the
gradients of the global batch over the ranks; only rank 0 writes the
outdir.  Without it the trainer uses one card.
Outputs in --outdir: model.log, batch.log (iter, loss, gradientmax, gradientcap,
learning_rate, chunk_len), validation.log and model_checkpoint_XXXXX /
model_final .checkpoint and .params in the JAX package's checkpoint
format, the optimizer state included (a checkpoint given as `model`
resumes it).  --device defaults to the card; --device cpu
runs the kernels' plain twins.  f32 throughout (TF32 off).
"""

import argparse
import itertools
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from taiyaki_tpu_torch import __version__
from taiyaki_tpu_torch.utils.cmdargs import (
    AutoBool, Bounded, DeviceAction, FileExists, Maybe, NonNegative,
    ParseToNamedTuple, Positive, display_version_and_exit)

MAIN_LOG_POLKA_TMPLT = (
    ' {:5d} {:7.5f}   {:5.2f}s ({:.2f} ksample/s {:.2f} kbase/s) '
    'lr={:.2e}')
MAIN_LOG_VAL_TMPLT = (
    'iteration: {} validation_loss: {:7.5f} ({:5.2} Mbase in {:5.2f} s, '
    '{:.2f} kbase/s)\n')
BATCH_FIELDS = ['iter', 'loss', 'gradientmax', 'gradientcap',
                'learning_rate', 'chunk_len']
BATCH_TMPLT = '\t'.join('{}' for _ in BATCH_FIELDS) + '\n'
VAL_TMPLT = '{}\t{}\n'


def get_parser():
    """The options of bin/train_flipflop.py, --device defaulting to the
    card."""
    parser = argparse.ArgumentParser(
        description='Train flip-flop neural network on a CUDA card',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    mdl = parser.add_argument_group('Model Arguments')
    mdl.add_argument('--size', default=384, metavar='neurons',
                     type=Positive(int),
                     help='Width (hidden units) of the recurrent layers')
    mdl.add_argument('--stride', default=5, metavar='samples',
                     type=Positive(int),
                     help='Downsampling stride of the convolution front end')
    mdl.add_argument('--winlen', default=19, type=Positive(int),
                     help='Convolution front-end window width in samples')

    trn = parser.add_argument_group('Training Arguments')
    trn.add_argument('--adam', nargs=2, metavar=('beta1', 'beta2'),
                     default=[0.9, 0.999], type=NonNegative(float),
                     help='Adam first/second-moment decay rates')
    trn.add_argument('--eps', default=1e-6, metavar='adjustment',
                     type=Positive(float), help='Adam denominator epsilon')
    trn.add_argument('--niteration', metavar='batches', type=Positive(int),
                     default=150000,
                     help='Total training iterations (optimizer steps)')
    trn.add_argument('--weight_decay', default=0.01, metavar='penalty',
                     type=NonNegative(float),
                     help='Decoupled (AdamW) weight-decay coefficient')
    trn.add_argument('--gradient_clip_num_mads', default=0,
                     metavar='num_MADs', type=Maybe(NonNegative(float)),
                     help='Value-clip gradients at this many MADs above the '
                          'running median of the last 1000 per-step '
                          'gradient maxima; "None" disables clipping.')
    trn.add_argument('--lr_max', default=4.0e-3, metavar='rate',
                     type=Positive(float),
                     help='Peak learning rate, at the end of the warmup')
    trn.add_argument('--lr_min', default=1.0e-4, metavar='rate',
                     type=Positive(float),
                     help='Learning-rate floor; the schedule starts and '
                          'ends here')
    trn.add_argument('--seed', default=None, metavar='integer',
                     type=Positive(int),
                     help='Seed for all RNGs (parameter init and data '
                          'order)')
    trn.add_argument('--sharpen', default=(1.0, 1.0, 25000), nargs=3,
                     metavar=('min', 'max', 'niter'),
                     action=ParseToNamedTuple,
                     type=(Positive(float), Positive(float), Positive(int)),
                     help='Linear sharpening-factor ramp from "min" to '
                          '"max" over "niter" iterations')
    trn.add_argument('--warmup_batches', type=int, default=200,
                     help='Ramp the learning rate up over the first n '
                          'steps (cosine-shaped)')
    trn.add_argument('--lr_warmup', metavar='rate', type=Positive(float),
                     help='Learning rate at the start of warmup (default: '
                          'lr_min)')
    trn.add_argument('--min_momentum', type=Positive(float),
                     help='Lower bound for momentum cycling; omit to keep '
                          'momentum fixed at Adam beta1')

    dat = parser.add_argument_group('Data Arguments')
    dat.add_argument('--filter_max_dwell', default=10.0, metavar='multiple',
                     type=Maybe(Positive(float)),
                     help='Reject a chunk whose longest dwell exceeds this '
                          'multiple of the median dwell')
    dat.add_argument('--filter_mean_dwell', default=3.0, metavar='radius',
                     type=Maybe(Positive(float)),
                     help='Reject a chunk whose mean dwell is more than '
                          'radius deviations from the median')
    dat.add_argument('--filter_min_pass_fraction', default=0.5,
                     metavar='fraction', type=Maybe(Positive(float)),
                     help='Give up sampling when the pass rate falls below '
                          'this fraction')
    dat.add_argument('--filter_path_buffer', default=1.1, metavar='ratio',
                     type=Bounded(float, lower=1.0, upper=float('inf')),
                     help='Reject a chunk unless its signal length exceeds '
                          'bases * stride * this ratio')
    dat.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                     help='Use at most this many reads from the input')
    dat.add_argument('--reverse', default=False, action=AutoBool,
                     help='Flip signal and sequence time order (RNA)')
    dat.add_argument('--sample_nreads_before_filtering', metavar='n',
                     type=NonNegative(int), default=100000,
                     help='Estimate chunk-filter bounds from n reads (0 = '
                          'every read)')
    dat.add_argument('--chunk_len_min', default=3000, metavar='samples',
                     type=Positive(int),
                     help='Shortest chunk length to sample, in samples')
    dat.add_argument('--chunk_len_max', default=8000, metavar='samples',
                     type=Positive(int),
                     help='Longest chunk length to sample, in samples')
    dat.add_argument('--chunk_len_buckets', default=8, metavar='n',
                     type=Positive(int),
                     help='Number of distinct chunk lengths sampled from '
                          '[chunk_len_min, chunk_len_max]')
    dat.add_argument('--seqlen_buckets', default=True, action=AutoBool,
                     help='Pad each batch\'s sequences to the smallest '
                          'multiple of 128 that fits it')
    dat.add_argument('--include_reporting_strands', default=False,
                     action=AutoBool,
                     help='Train on the validation reads too')
    dat.add_argument('--input_strand_list', default=None, action=FileExists,
                     help='Restrict training to the read_id column of this '
                          'TSV')
    dat.add_argument('--min_sub_batch_size', default=128, metavar='chunks',
                     type=Positive(int),
                     help='Chunks per sub-batch at the longest chunk '
                          'length (scaled up for shorter chunks)')
    dat.add_argument('--reporting_percent_reads', default=1,
                     metavar='sub_batches', type=Positive(float),
                     help='Percentage of reads held out for validation')
    dat.add_argument('--reporting_strand_list', action=FileExists,
                     help='TSV whose read_id column names the validation '
                          'reads')
    dat.add_argument('--reporting_sub_batches', default=100,
                     metavar='sub_batches', type=Positive(int),
                     help='Sub-batches evaluated for the validation loss')
    dat.add_argument('--standardize', default=True, action=AutoBool,
                     help='Normalize each read\'s current before chunking')
    dat.add_argument('--sub_batches', default=1, metavar='sub_batches',
                     type=Positive(int),
                     help='Sub-batches accumulated into each optimizer step')

    cmp = parser.add_argument_group('Compute Arguments')
    cmp.add_argument('--device', default='cuda', action=DeviceAction,
                     help='Device: "cuda" (default), "cpu" or an integer '
                          'CUDA device index')
    cmp.add_argument('--multihost', default=False, action=AutoBool,
                     help='Join a data-parallel job, one process per '
                          'card (rendezvous from TAIYAKI_COORDINATOR, '
                          'TAIYAKI_NUM_PROCS and TAIYAKI_PROC_ID, or '
                          'torchrun\'s variables)')
    cmp.add_argument('--remat', default=False, action=AutoBool,
                     help='Rematerialize layer activations: keep no layer\'s '
                          'activations for the backward pass, which runs '
                          'each layer\'s forward again')

    out = parser.add_argument_group('Output Arguments')
    out.add_argument('--full_filter_status', default=False, action=AutoBool,
                     help='Log per-criterion chunk rejection counts')
    out.add_argument('--outdir', default='training',
                     help='Directory for logs and checkpoints')
    out.add_argument('--overwrite', default=False, action=AutoBool,
                     help='Reuse an existing output directory')
    out.add_argument('--quiet', default=False, action=AutoBool,
                     help='Suppress progress output on stdout')
    out.add_argument('--save_every', metavar='x', type=Positive(int),
                     default=2500, help='Write a checkpoint every x '
                                        'iterations')
    out.add_argument('--profile', default=False, action=AutoBool,
                     help='Write a torch.profiler trace of iterations 10-15 '
                          'to outdir/profile')

    mod = parser.add_argument_group('Modified Base Arguments')
    mod.add_argument('--mod_factor', default=(8.0, 1.0, 50000), nargs=3,
                     metavar=('start', 'final', 'niter'),
                     action=ParseToNamedTuple,
                     type=(Positive(float), Positive(float), Positive(int)),
                     help='Linear ramp of the modified-base loss weight '
                          'from "start" to "final" over "niter" iterations '
                          '(cat_mod models)')
    mod.add_argument('--mod_prior_factor', type=float,
                     help='Weight mod categories by their log-odds priors '
                          'raised to this power (default: unweighted)')
    mod.add_argument('--num_mod_weight_reads', type=int, default=5000,
                     help='Reads sampled for the mod-base priors')

    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit, metavar=__version__,
                        help='Print the version string and exit.')
    parser.add_argument('model', action=FileExists,
                        help='Model definition (.py) or checkpoint to start '
                             'from')
    parser.add_argument('input', action=FileExists,
                        help='mapped-signal HDF5 file with the training '
                             'reads')
    return parser


def _pad_batch(batch, target):
    """Repeat-pad a short batch to the sub-batch size; padded rows get
    seqlens == 0, which the loss leaves out entirely."""
    from taiyaki_tpu_torch.train import Batch
    n = batch.signal.shape[1]
    if n == 0:
        raise RuntimeError('No chunks passed filters — cannot build batch. '
                           'Check filter parameters.')
    reps = [min(i, n - 1) for i in range(target)]
    seqlens = batch.seqlens[reps].copy()
    seqlens[n:] = 0
    return Batch(batch.signal[:, reps, :], batch.seqs[reps], seqlens,
                 None if batch.mod_cats is None else batch.mod_cats[reps])


def main(argv=None):
    """Train; returns {"iterations", "samples", "bases", "seconds",
    "device"} of the training loop."""
    args = get_parser().parse_args(argv)
    import torch
    from taiyaki_tpu_torch.cli.basecall import select_device

    # f32 end to end: no TF32 in matrix products or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = None
    if args.multihost:
        from taiyaki_tpu_torch.parallel import mesh
        try:
            init = mesh.rendezvous()
        except ValueError as e:
            sys.exit('* Error: --multihost: {}'.format(e))
        spec = args.device
        if spec == 'cuda' and torch.cuda.is_available():
            spec = init[2] % torch.cuda.device_count()   # a card a rank
        job = mesh.start(select_device(spec), *init)
    try:
        return _train(args, job)
    finally:
        if job is not None:
            job.close()


def _train(args, job):
    """The training run of `main` in a data-parallel `job`, or alone where
    it is None."""
    import torch
    from taiyaki_tpu_torch import layers, train
    from taiyaki_tpu_torch.cli.basecall import select_device
    from taiyaki_tpu_torch.constants import (
        BATCH_LOG_FILENAME, DOTROWLENGTH, MODEL_LOG_FILENAME,
        VALID_LOG_FILENAME)
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    from taiyaki_tpu_torch.utils import helpers

    device = select_device(args.device) if job is None else job.device
    is_lead = job is None or job.is_lead
    if is_lead:
        helpers.prepare_outdir(args.outdir, args.overwrite)

    def logger(name, quiet):
        return helpers.Logger(os.path.join(args.outdir, name) if is_lead
                              else None, quiet)

    log = logger(MODEL_LOG_FILENAME, args.quiet)
    batch_log = logger(BATCH_LOG_FILENAME, True)
    val_log = logger(VALID_LOG_FILENAME, True)
    log.write(helpers.formatted_env_info(device))
    batch_log.write(BATCH_TMPLT.format(*BATCH_FIELDS))
    val_log.write(VAL_TMPLT.format('iter', 'loss'))
    if job is not None:
        log.write('* Rank {} of {} on {}; gradients all-reduced over {}.\n'
                  .format(job.rank, job.world_size, device, job.backend))
    elif device.type == 'cuda' and torch.cuda.device_count() > 1:
        log.write('* Training on {} of {} cards: --multihost with one '
                  'process per card uses them all.\n'.format(
                      device, torch.cuda.device_count()))

    seed = (np.random.randint(0, 2 ** 31) if args.seed is None
            else args.seed)
    reducer = None
    if job is not None:
        # every rank draws the same weights, holdout and chunk lengths
        seed = job.broadcast(seed)
        if job.world_size > 1:
            from taiyaki_tpu_torch.utils import hostsync
            reducer = hostsync.start()
    # the JAX trainer's streams, in its order: the global state (filter
    # sampling, holdout, then chunks), the init stream, the bucket stream
    np.random.seed(seed)
    rng = np.random.default_rng(seed)
    bucket_rng = np.random.default_rng(2 ** 32 + seed)
    log.write('* Using random seed {}\n'.format(seed))

    # ---- data -----------------------------------------------------------
    log.write('* Loading data from {}\n'.format(args.input))
    log.write('* Per read file MD5 {}\n'.format(helpers.file_md5(args.input)))
    with mapped_signal_files.MappedSignalReader(args.input) as msr:
        alphabet_info = msr.get_alphabet_information()
        if args.input_strand_list is not None:
            from taiyaki_tpu_torch.utils.fileio import readtsv
            read_ids = list(readtsv(args.input_strand_list,
                                    ['read_id'])['read_id'])
            log.write('* Will train from a subset of {} strands, determined '
                      'by read_ids in input strand list\n'.format(
                          len(read_ids)))
        else:
            read_ids = None
        read_data = list(msr.reads(read_ids))
        if args.limit is not None:
            read_data = read_data[:args.limit]
    if len(read_data) == 0:
        log.write('* No reads remaining for training, exiting.\n')
        sys.exit(1)
    log.write('* Loaded {} reads.\n'.format(len(read_data)))
    log.write('* Reading network from {}\n'.format(args.model))

    # ---- network --------------------------------------------------------
    model_kwargs = {
        'size': args.size, 'stride': args.stride, 'winlen': args.winlen,
        'insize': 1, 'alphabet_info': alphabet_info}
    model_metadata = {'reverse': args.reverse,
                      'standardize': args.standardize}
    net, params, model_source, metadata, model_kwargs, opt_state_ckpt = \
        helpers.load_model(args.model, model_metadata=model_metadata,
                           **model_kwargs)
    if params is None:
        params = net.init(rng)
    head = net.sublayers[-1]
    is_cat_mod = layers.is_cat_mod_model(net)
    if is_cat_mod:
        if not alphabet_info.is_compatible_model(net):
            sys.exit('* Error: model alphabet does not match mapped signal '
                     'file alphabet')
        can_mods_offsets = head.can_mods_offsets
        can_labels, mod_labels = head.can_labels, head.mod_labels
        if args.mod_prior_factor is None:
            mod_cat_weights = np.ones(head.ncan_base + head.nmod_base,
                                      dtype=np.float32)
        else:
            mod_cat_weights = alphabet_info.compute_log_odds_weights(
                read_data, args.num_mod_weight_reads)
            log.write('* Computed modbase log odds priors:  {}\n'.format(
                '  '.join('{}:{:.4f}'.format(*x) for x in
                          zip(alphabet_info.alphabet, mod_cat_weights))))
            if args.mod_prior_factor != 1.0:
                mod_cat_weights = np.power(mod_cat_weights,
                                           args.mod_prior_factor)
                log.write('* Applied mod_prior_factor to modbase log odds '
                          'priors:  {}\n'.format(
                              '  '.join('{}:{:.4f}'.format(*x) for x in
                                        zip(alphabet_info.alphabet,
                                            mod_cat_weights))))
    else:
        if not isinstance(head, layers.GlobalNormFlipFlop):
            sys.exit('* Error: only flip-flop and cat_mod flip-flop models '
                     'are ported')
        if alphabet_info.nbase != head.nbase:
            sys.exit('* Error: number of bases in alphabet does not match '
                     'model')
        can_mods_offsets = can_labels = mod_labels = None
        mod_cat_weights = None
    cat_mod = (is_cat_mod, can_mods_offsets, mod_cat_weights)
    net = load_jax_params(net, params).to(device).train()
    layers.set_remat(net, args.remat)
    stride = net.stride
    params = train.leaf_params(net)
    log.write('* Network has {} parameter tensors, stride {}.\n'.format(
        len(params), stride))

    # ---- optimizer ------------------------------------------------------
    lr_warmup = args.lr_min if args.lr_warmup is None else args.lr_warmup
    if args.warmup_batches >= args.niteration:
        sys.exit('* Error: --warmup_batches must be < --niteration')
    if args.chunk_len_min > args.chunk_len_max:
        sys.exit('* Error: --chunk_len_min greater than --chunk_len_max')
    optimizer, schedule = train.make_optimizer(
        params, args.lr_max, args.niteration,
        args.warmup_batches, lr_warmup, args.lr_min,
        adam_betas=tuple(args.adam), eps=args.eps,
        weight_decay=args.weight_decay, min_momentum=args.min_momentum)
    if args.min_momentum is not None:
        log.write('* Momentum cycling between {} and {} (inverse to LR).\n'
                  .format(args.adam[0], args.min_momentum))
    if opt_state_ckpt is not None:
        optimizer.load_jax_state(net, opt_state_ckpt)
    log.write('* Learning rate increases from {:.2e} to {:.2e} over {} '
              'iterations using cosine schedule.\n'.format(
                  lr_warmup, args.lr_max, args.warmup_batches))
    log.write('* Then learning rate decreases from {:.2e} to {:.2e} over {} '
              'iterations using cosine schedule.\n'.format(
                  args.lr_max, args.lr_min,
                  args.niteration - args.warmup_batches))
    capper = train.GradientCapper(len(params), args.gradient_clip_num_mads)
    if args.gradient_clip_num_mads is None:
        log.write('* No gradient clipping\n')
    else:
        log.write('* Gradients will be clipped (by value) at {:3.2f} MADs '
                  'above the median of the last 1000 gradient maximums.\n'
                  .format(args.gradient_clip_num_mads))
    group = None if job is None else job.group
    step_fn = train.make_train_step(net, optimizer, *cat_mod, group=group)
    if args.sub_batches > 1:
        grad_fn = train.make_grad_step(net, *cat_mod, group=group)
        apply_fn = train.make_apply_step(optimizer)

    # ---- filters & reporting data ---------------------------------------
    log.write('* Estimating filter parameters from training data\n')
    filter_params = chunk_selection.sample_filter_parameters(
        read_data, args.sample_nreads_before_filtering, args.chunk_len_max,
        args.filter_mean_dwell, args.filter_max_dwell,
        args.filter_min_pass_fraction, stride, args.filter_path_buffer)
    log.write('* Sampled chunks: median(mean_dwell)={:.2f}, '
              'mad(mean_dwell)={:.2f}\n'.format(
                  filter_params.median_meandwell,
                  filter_params.mad_meandwell))
    if args.reporting_strand_list is not None:
        from taiyaki_tpu_torch.utils.fileio import readtsv
        reporting_ids = set(
            str(v) for v in readtsv(args.reporting_strand_list,
                                    ["read_id"])["read_id"])
        report_idx = set(i for i, r in enumerate(read_data)
                         if r.read_id in reporting_ids)
        log.write('* Reporting strands from {} ({} found).\n'.format(
            args.reporting_strand_list, len(report_idx)))
    else:
        n_report = max(1, int(len(read_data) * args.reporting_percent_reads
                              / 100.0))
        report_idx = set(np.random.choice(len(read_data), n_report,
                                          replace=False))
    reporting_data = [read_data[i] for i in sorted(report_idx)]
    if not args.include_reporting_strands:
        read_data = [r for i, r in enumerate(read_data)
                     if i not in report_idx]
        log.write('* Holding out {} reads for validation, training on {}.\n'
                  .format(len(reporting_data), len(read_data)))

    buckets = train.chunk_len_buckets(args.chunk_len_min, args.chunk_len_max,
                                      stride, args.chunk_len_buckets)
    log.write('* Chunk length buckets: {}\n'.format(buckets))
    mid_len = (args.chunk_len_min + args.chunk_len_max) // 2
    val_chunk_len = min(buckets, key=lambda b: abs(b - mid_len))
    val_max_seqlen = train.max_seqlen_for_chunk(val_chunk_len, stride,
                                                args.filter_path_buffer)
    seqlen_gran = 128 if args.seqlen_buckets else None
    reporting_batches = []
    first_strand = 0
    for _ in range(args.reporting_sub_batches):
        vb, vrej = train.sample_batch(
            reporting_data, val_chunk_len, args.min_sub_batch_size,
            val_max_seqlen, alphabet_info, filter_params,
            reverse=args.reverse, standardize=args.standardize,
            can_labels=can_labels, mod_labels=mod_labels,
            select_strands_randomly=False, first_strand_index=first_strand,
            seqlen_granularity=seqlen_gran)
        first_strand += sum(vrej.values())
        if vb.signal.shape[1] > 0:
            reporting_batches.append(vb)
    loss_fn = train.make_loss_fn(net, *cat_mod)
    sharpen_sched = train.linear_ramp(args.sharpen.min, args.sharpen.max,
                                      args.sharpen.niter)
    mod_factor_sched = train.linear_ramp(
        args.mod_factor.start, args.mod_factor.final, args.mod_factor.niter)

    # ---- training loop --------------------------------------------------
    score_smoothed = helpers.WindowedExpSmoother()
    rejection_dict = defaultdict(int)
    total_bases = total_samples = 0
    counts = dict(samples=0, bases=0)
    sample_counter = itertools.count()

    def sample_iteration():
        """Sample one iteration's sub-batches (host work, on the prefetch
        thread so that it overlaps the previous step on the card)."""
        batch_chunk_len = buckets[bucket_rng.integers(len(buckets))]
        sub_batch_size = train.sub_batch_size_for_chunk(
            args.min_sub_batch_size, args.chunk_len_max, batch_chunk_len)
        if job is not None:
            # the global sub-batch, rounded down to a multiple of the
            # ranks, splits evenly: this rank's share
            sub_batch_size = max(1, sub_batch_size // job.world_size)
        max_seqlen = train.max_seqlen_for_chunk(
            batch_chunk_len, stride, args.filter_path_buffer)
        it_idx = next(sample_counter)
        batches, nvalids = [], []
        rejections_total = defaultdict(int)
        sample_count = base_count = 0
        for sub in range(args.sub_batches):
            tag = '{}.{}'.format(it_idx, sub)
            batch, rejections = train.sample_batch(
                read_data, batch_chunk_len, sub_batch_size, max_seqlen,
                alphabet_info, filter_params, reverse=args.reverse,
                standardize=args.standardize, can_labels=can_labels,
                mod_labels=mod_labels, log=log,
                seqlen_granularity=seqlen_gran,
                seqlen_reduce=(_seqlen_sync(reducer, tag)
                               if seqlen_gran and reducer is not None
                               else None))
            for k, v in rejections.items():
                rejections_total[k] += v
            if batch.signal.shape[1] < sub_batch_size:
                batch = _pad_batch(batch, sub_batch_size)
            sample_count += int(batch.signal.size)
            base_count += int(np.sum(batch.seqlens))
            # a rank's loss divides by the global batch's real rows
            nvalid = None if job is None else int(np.sum(batch.seqlens > 0))
            if reducer is not None:
                nvalid = reducer.total(tag + '.n', nvalid)
            nvalids.append(nvalid)
            batches.append(train.batch_to_device(batch, device))
        return (batch_chunk_len, list(zip(batches, nvalids)),
                rejections_total, (sample_count, base_count))

    # from here on the global stream draws training chunks, a stream a rank
    np.random.seed(seed + (0 if job is None else job.rank))
    prefetch = ThreadPoolExecutor(max_workers=1)
    next_batches = prefetch.submit(sample_iteration)
    time_last = t_start = time.time()
    log.write('* Training\n')
    pending = None

    def process_iteration(p):
        nonlocal total_samples, total_bases, time_last
        it = p['iter']
        fval = float(sum(float(x) for x in p['losses'])) / args.sub_batches
        if not np.isfinite(fval):
            log.write('\n* Error: loss is not finite at iteration {}.\n'
                      '* Try restarting from a checkpoint with a lower '
                      'learning rate.\n'.format(it + 1))
            sys.exit(1)
        grad_maxs = p['grad_maxs'].cpu().numpy()
        capper.update(grad_maxs)
        batch_log.write(BATCH_TMPLT.format(
            it + 1, fval, ','.join(str(float(g)) for g in grad_maxs),
            ','.join('NA' if not np.isfinite(t) else str(float(t))
                     for t in p['threshs']),
            float(schedule(it)), p['chunk_len']))
        score_smoothed.update(fval)
        log.write('.')
        total_samples += p['samples']
        total_bases += p['bases']
        counts['samples'] += p['samples']
        counts['bases'] += p['bases']
        if (it + 1) % DOTROWLENGTH == 0:
            dt = time.time() - time_last
            log.write(MAIN_LOG_POLKA_TMPLT.format(
                (it + 1) // DOTROWLENGTH, score_smoothed.value, dt,
                total_samples / 1000.0 / dt, total_bases / 1000.0 / dt,
                float(schedule(it))))
            if args.full_filter_status:
                for k, v in rejection_dict.items():
                    log.write(' {}:{} '.format(k, v))
            else:
                n_tot = sum(rejection_dict.values())
                n_fail = n_tot - rejection_dict['pass']
                log.write('  {:.1%} chunks filtered'.format(
                    n_fail / max(n_tot, 1)))
            log.write('\n')
            time_last = time.time()
            total_bases = total_samples = 0

    # a checkpoint's weights and optimizer state are copied to the host
    # when it is taken and written to disk on a writer thread, overlapping
    # the steps that follow; each save first waits for the one before
    writer = ThreadPoolExecutor(max_workers=1)
    writing = None

    def save(index):
        nonlocal writing
        if not is_lead:
            return None
        if writing is not None:
            writing.result()
        writing = writer.submit(
            helpers.save_model, args.outdir, net, params_to_jax(net),
            model_source, model_kwargs, metadata, index,
            optimizer.jax_state(net))
        return os.path.join(args.outdir,
                            helpers.checkpoint_name(index) + '.checkpoint')

    prof = None
    for curr_iter in range(args.niteration):
        if args.profile and is_lead and curr_iter == 10:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
            prof = profile(activities=acts)
            prof.__enter__()
        if prof is not None and curr_iter == 15:
            prof.__exit__(None, None, None)
            _write_trace(prof, args.outdir, log)
            prof = None
        sharpen = sharpen_sched(curr_iter)
        mod_factor = mod_factor_sched(curr_iter)
        (batch_chunk_len, batches, rejections,
         (iter_samples, iter_bases)) = next_batches.result()
        if curr_iter + 1 < args.niteration:
            next_batches = prefetch.submit(sample_iteration)
        for k, v in rejections.items():
            rejection_dict[k] += v

        losses = []
        used_threshs = capper.thresholds.copy()
        if args.sub_batches == 1:
            for batch, nvalid in batches:
                loss, grad_maxs = step_fn(batch, sharpen, used_threshs,
                                          mod_factor, nvalid)
                losses.append(loss)
        else:
            acc = None
            for batch, nvalid in batches:
                loss, grads = grad_fn(batch, sharpen, mod_factor, nvalid)
                acc = train.accumulate_grads(acc, grads)
                losses.append(loss)
            grad_maxs = apply_fn(acc, float(args.sub_batches), used_threshs)

        # read the previous iteration's results while this one runs
        if pending is not None:
            process_iteration(pending)
        pending = dict(iter=curr_iter, losses=losses, grad_maxs=grad_maxs,
                       threshs=used_threshs, chunk_len=batch_chunk_len,
                       samples=iter_samples, bases=iter_bases)

        if (curr_iter + 1) % args.save_every == 0:
            # every rank feeds its capper, which sets the next clip
            process_iteration(pending)
            pending = None
        if (curr_iter + 1) % args.save_every == 0 and is_lead:
            saved = save((curr_iter + 1) // args.save_every)
            log.write('Model saved to {}.\n'.format(saved))
            t0 = time.time()
            vlosses, vbases = [], 0
            with torch.no_grad():
                for vb in reporting_batches:
                    vlosses.append(float(loss_fn(
                        train.batch_to_device(vb, device),
                        args.sharpen.max, args.mod_factor.final)))
                    vbases += int(np.sum(vb.seqlens))
            rloss = float(np.mean(vlosses)) if vlosses else float('nan')
            dt = time.time() - t0
            log.write(MAIN_LOG_VAL_TMPLT.format(
                curr_iter + 1, rloss, vbases / 1e6, dt, vbases / 1e3 / dt))
            val_log.write(VAL_TMPLT.format(curr_iter + 1, rloss))
            total_bases = total_samples = 0
            time_last = time.time()

    if pending is not None:
        process_iteration(pending)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    seconds = time.time() - t_start
    prefetch.shutdown(wait=False)
    if prof is not None:
        prof.__exit__(None, None, None)
        _write_trace(prof, args.outdir, log)
    save(None)
    if writing is not None:
        writing.result()
    writer.shutdown()
    log.write('\n* Training complete.\n')
    for lg in (log, batch_log, val_log):
        lg.close()
    return dict(iterations=args.niteration, samples=counts['samples'],
                bases=counts['bases'], seconds=seconds, device=str(device))


def _seqlen_sync(reducer, tag):
    """The cross-rank max of the sampled sequence length for `tag` (issued
    in the same order on every rank: iteration.sub_batch), on the
    reducer's own gloo group (`utils.hostsync`): the sampler runs on the
    prefetch thread, beside the main thread's gradient all-reduces."""
    return lambda local_max: reducer.reduce(tag, local_max)


def _write_trace(prof, outdir, log):
    path = os.path.join(outdir, 'profile')
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, 'trace.json'))
    log.write('* Profiler trace written to {}\n'.format(path))


if __name__ == '__main__':
    main()
