"""Basecall reads with a trained flip-flop model on an NVIDIA card (port of
bin/basecall.py).

    python -m taiyaki_tpu_torch.cli.basecall [options] reads_dir model.checkpoint

Per batch of chunks: network forward (LSTM kernels), temperature, posterior
transition probabilities (logZ forward and posterior kernels), log, Viterbi
(plain PyTorch; not with --beam), and for fastq the per-base error
probabilities.  Chunks of consecutive reads are pooled into shared
batches, the last part of a batch is padded by repeating its last chunk,
and a read shorter than a chunk is zero-padded to the chunk length and
trimmed after, as in bin/basecall.py.
With --beam, the posterior scores of each read's chunks come back to the
host, are stitched and decoded there by the prefix beam search
(`decodeutil.beamsearch`, C++), and for fastq the beam's bases are aligned
back to the blocks by the remap Viterbi (`flipflop_remap`) to read their
error probabilities, as bin/basecall.py does.
With --modified_base_output and a cat_mod model, only the canonical
transition columns go to the posterior and Viterbi; the mod columns are
stitched and read per called base (`flipflopfings.path_mod_scores`) into
an HDF5 file (`data.hdf5.Writer`): `mod_long_names` and
`Reads/<read_id>` f32 [nbase, nmods], NaN where a mod does not apply.
With several devices (--ndevices, by default every card unless --device
is an index) each batch's chunks split into equal contiguous parts, one
a device, each run by its own replica of the network; the results come
back in chunk order.
All arithmetic is f32 (TF32 is switched off for matrix products and
convolutions).  --device defaults to the card; --device cpu runs the plain
PyTorch twins of the kernels.
"""

import argparse
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from taiyaki_tpu_torch import basecall_helpers
from taiyaki_tpu_torch.utils.cmdargs import (
    AutoBool, FileExists, NonNegative, ParseToNamedTuple, Positive)
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def _boolish(s):
    if str(s).lower() in ("false", "0", "no", "off"):
        return False
    if str(s).lower() in ("true", "1", "yes", "on"):
        return True
    raise argparse.ArgumentTypeError("expected a boolean, got %r" % s)


def get_parser():
    parser = argparse.ArgumentParser(
        description="Basecall reads using a taiyaki_tpu model on a CUDA card",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(
        parser, """alphabet device input_folder input_strand_list jobs
        limit output quiet recursive version""".split())
    parser.add_argument(
        "--beam", default=None, metavar=("width", "guided"), nargs=2,
        type=(int, _boolish), action=ParseToNamedTuple,
        help="Decode with the prefix beam search instead of Viterbi")
    parser.add_argument(
        "--chunk_size", type=Positive(int), metavar="blocks",
        default=basecall_helpers.DEFAULT_CHUNK_SIZE,
        help="Size of signal chunks sent to device is chunk_size * model "
             "stride")
    parser.add_argument(
        "--fastq", default=False, action=AutoBool,
        help="Emit fastq with per-base q scores rather than fasta")
    parser.add_argument(
        "--max_concurrent_chunks", type=Positive(int), default=128,
        help="Maximum number of chunks to call at once")
    parser.add_argument(
        "--ndevices", type=Positive(int), default=None,
        help="Number of devices to shard chunk batches over (default: every "
             "card, or 1 with an index for --device; with --device cpu, "
             "replicas on the CPU)")
    parser.add_argument(
        "--overlap", type=NonNegative(int), metavar="blocks",
        default=basecall_helpers.DEFAULT_OVERLAP,
        help="Overlap between signal chunks sent to device")
    parser.add_argument(
        "--posterior", default=True, action=AutoBool,
        help="Decode by Viterbi over posteriors rather than transition scores")
    parser.add_argument(
        "--qscore_offset", type=float, default=0.0,
        help="Additive q-score adjustment, applied after scaling (fastq)")
    parser.add_argument(
        "--qscore_scale", type=float, default=1.0,
        help="Multiplicative q-score calibration factor (fastq)")
    parser.add_argument(
        "--reverse", default=False, action=AutoBool,
        help="Emit called sequences reversed (RNA 3p->5p order)")
    parser.add_argument(
        "--scaling", action=FileExists, default=None,
        help="TSV of per-read current scaling parameters")
    parser.add_argument(
        "--temperature", default=1.0, type=float,
        help="Multiply network outputs by this factor before decoding")
    parser.add_argument(
        "--modified_base_output", default=None,
        help="HDF5 file for the per-base modified-base scores of a cat_mod "
             "model")
    parser.add_argument(
        "model", action=FileExists,
        help="Checkpoint holding the trained network to call with")
    return parser


def select_device(spec):
    """torch.device for a --device value ("cpu", "cuda" or an index);
    exits if a card is asked for and CUDA is not available."""
    if spec == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit("* Error: --device {} needs a CUDA card, but CUDA is not "
                 "available; pass --device cpu to run on the CPU"
                 .format(spec))
    if isinstance(spec, int):
        return torch.device("cuda", spec)
    if spec == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    sys.exit("* Error: unknown --device {!r} (cpu, cuda or an index)"
             .format(spec))


def med_mad_norm(x, dtype="f4"):
    from taiyaki_tpu_torch.maths import med_mad
    med, mad = med_mad(x)
    return ((x - med) / mad).astype(dtype)


def get_signal(read_filename, read_id):
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.data.signal import Signal
    try:
        with fast5utils.get_fast5_file(read_filename) as f5:
            return Signal(f5.get_read(read_id)).current
    except Exception as e:
        sys.stderr.write(
            "Unable to obtain signal for {} from {}.\n{}\n".format(
                read_id, read_filename, repr(e)))
        return None


class Basecaller:
    """Network forward + (posterior) + Viterbi (+ error probabilities) for
    batches of up to `max_batch` chunks on `device`, or on a list of
    devices: one replica of the network a device (the parameters copied
    once), each batch split into equal contiguous parts, one a device,
    `max_batch` rounded down to a multiple of their number.  With
    want_paths=False (the beam decodes on the host) no Viterbi."""

    def __init__(self, net, n_can_state, posterior, temperature, max_batch,
                 device, want_errprobs=False, want_trans=False,
                 want_mods=False, want_paths=True):
        import copy
        from taiyaki_tpu_torch import flipflopfings, qscores
        from taiyaki_tpu_torch.parallel.mesh import round_batch_to_mesh
        self.devices = (list(device) if isinstance(device, (list, tuple))
                        else [device])
        self.nets = [net.to(self.devices[0])] + [
            copy.deepcopy(net).to(d) for d in self.devices[1:]]
        self.n_can_state = n_can_state
        self.posterior = posterior
        self.temperature = temperature
        self.max_batch = round_batch_to_mesh(max_batch, self.devices)
        self.want_errprobs = want_errprobs
        self.want_trans = want_trans
        self.want_mods = want_mods
        self.want_paths = want_paths
        self.nbases = flipflopfings.nbase_flipflop(n_can_state)
        mask = np.zeros((n_can_state, self.nbases), dtype=np.float32)
        for b in range(self.nbases):
            mask[qscores.transitions_into_base(b, self.nbases), b] = 1.0
        # a copy a device, by its name
        self.base_masks = {str(d): torch.from_numpy(mask).to(d)
                           for d in self.devices}

    def errprobs(self, trans, paths):
        """Per-path-position error probabilities, as
        qscores.errprobs_from_trans computes them (on log posteriors, as
        the reference does); row 0 is -1."""
        from taiyaki_tpu_torch.constants import SMALL_VAL
        baseprobs = torch.matmul(trans, self.base_masks[str(trans.device)])
        baseprobs = baseprobs / (baseprobs.sum(dim=2, keepdim=True)
                                 + SMALL_VAL)
        dest = (paths[1:] % self.nbases).long()
        p = baseprobs.gather(2, dest[..., None])[..., 0]
        return torch.cat([torch.full((1, paths.shape[1]), -1.0,
                                     device=trans.device), 1.0 - p], dim=0)

    def call_chunks(self, chunks, replica=0):
        """chunks [T, n, 1] on the device of `replica` -> {("paths"),
        ("errprobs"), ("trans": the scores to decode), ("mods": the
        output's columns past the canonical transitions)}."""
        from taiyaki_tpu_torch.ops import decode
        out = self.nets[replica](chunks)
        trans = out[:, :, :self.n_can_state] * self.temperature
        if self.posterior:
            trans = torch.log(decode.flipflop_make_trans(trans) + 1e-8)
        res = {}
        if self.want_paths:
            res["paths"] = decode.flipflop_viterbi(trans)[2]
        if self.want_mods:
            res["mods"] = out[:, :, self.n_can_state:]
        if self.want_errprobs:
            res["errprobs"] = self.errprobs(trans, res["paths"])
        if self.want_trans:
            res["trans"] = trans
        return res

    def submit(self, chunks):
        """Queue chunks [T, nchunk, 1] (numpy) on the devices in parts of
        max_batch, the last part padded by repeating its last chunk, each
        part split over the devices; returns [(valid columns, [device
        results, a device])]."""
        handles = []
        share = self.max_batch // len(self.devices)
        for i in range(0, chunks.shape[1], self.max_batch):
            part = chunks[:, i:i + self.max_batch]
            k = part.shape[1]
            if k < self.max_batch:
                pad = np.repeat(part[:, -1:], self.max_batch - k, axis=1)
                part = np.concatenate([part, pad], axis=1)
            handles.append((k, [
                self.call_chunks(torch.from_numpy(
                    part[:, j * share:(j + 1) * share]).to(d), j)
                for j, d in enumerate(self.devices)]))
        return handles

    @staticmethod
    def gather(handles):
        """Results to the host, in chunk order: (paths [nblk+1, nchunk]
        int32 or 0 rows, errprobs [nblk+1, nchunk] or 0 rows, mods [nblk,
        nchunk, nmodcol] or 0 columns, trans [nblk, nchunk, nstate] or 0
        columns)."""
        keys = ("paths", "errprobs", "mods", "trans")
        out = {key: [] for key in keys}
        for k, parts in handles:
            res = parts[0]
            nblk = (res["paths"].shape[0] - 1 if "paths" in res
                    else res["trans"].shape[0])
            empty = {"paths": (0, k), "errprobs": (0, k),
                     "mods": (nblk, k, 0), "trans": (nblk, k, 0)}
            for key in keys:
                out[key].append(np.concatenate(
                    [r[key].cpu().numpy() for r in parts], axis=1)[:, :k]
                    if key in res else np.zeros(empty[key], np.float32))
        return tuple(np.concatenate(out[key], axis=1) for key in keys)


def prepare_read(read_id, signal, chunk_size, overlap, read_params,
                 reverse_model):
    """Normalise + chunk a read; a read shorter than a chunk is zero-padded
    to chunk_size.  Returns the chunks and stitch metadata, or None."""
    if signal is None:
        return None
    if reverse_model:
        signal = signal[::-1]
    if read_params is None:
        normed = med_mad_norm(signal)
    else:
        normed = ((signal - read_params["shift"])
                  / read_params["scale"]).astype("f4")
    chunks, chunk_starts, chunk_ends = basecall_helpers.chunk_read(
        normed, chunk_size, overlap)
    true_len = chunks.shape[0]
    if true_len < chunk_size:
        pad = np.zeros((chunk_size - true_len, 1, 1), dtype=np.float32)
        chunks = np.concatenate([chunks, pad], axis=0)
    return dict(read_id=read_id, chunks=chunks, chunk_starts=chunk_starts,
                chunk_ends=chunk_ends, true_len=true_len,
                nsample=len(signal))


def finalize_read(prep, paths, errprobs, chunk_size, stride, alphabet,
                  fastq, qscore_scale, qscore_offset, mods=None,
                  can_nmods=None, trans=None, beam=None):
    """Stitch one read's paths, or with `beam` (width, guided) decode its
    stitched scores `trans` by the beam search, and assemble its call (and
    q-string, and with can_nmods its mod scores from `mods`).  Returns
    (basecall, qstring or None, mod scores [nbase, nmods] or None)."""
    from taiyaki_tpu_torch import qscores
    from taiyaki_tpu_torch.flipflopfings import path_to_str
    chunk_starts = prep["chunk_starts"]
    chunk_ends = prep["chunk_ends"]
    true_len = prep["true_len"]
    if true_len < chunk_size:
        nblk = -(-true_len // stride)
        paths = paths[:nblk + 1]
        errprobs = errprobs[:nblk + 1]
        if mods is not None:
            mods = mods[:nblk]
        if trans is not None:
            trans = trans[:nblk]
    qstring = None
    if beam is not None:
        best_path, qstring = beam_call(
            basecall_helpers.stitch_chunks(trans, chunk_starts, chunk_ends,
                                           stride),
            beam, alphabet, fastq, qscore_scale, qscore_offset)
    else:
        best_path = basecall_helpers.stitch_chunks(
            paths, chunk_starts, chunk_ends, stride)
        if fastq:
            stitched_errprobs = basecall_helpers.stitch_chunks(
                errprobs, chunk_starts, chunk_ends, stride)
            qstring = qscores.path_errprobs_to_qstring(
                stitched_errprobs, best_path, qscore_scale, qscore_offset)
    basecall = path_to_str(best_path, alphabet=alphabet,
                           include_first_source=False)
    mod_scores = None
    if can_nmods is not None:
        from taiyaki_tpu_torch.flipflopfings import path_mod_scores
        stitched_mods = basecall_helpers.stitch_chunks(
            mods, chunk_starts, chunk_ends, stride)
        # the move path[t] -> path[t+1] and its mod row both come from
        # output block t (path_mod_scores)
        n = min(len(best_path), len(stitched_mods) + 1)
        mod_scores = path_mod_scores(best_path[:n], stitched_mods, can_nmods)
    return basecall, qstring, mod_scores


def beam_call(stitched_trans, beam, alphabet, fastq, qscore_scale,
              qscore_offset):
    """One read's flip-flop state path by the prefix beam search over its
    stitched scores [nblk, nstate], and for fastq its q-string: the beam's
    bases carry no block alignment, so they are aligned back to the blocks
    by the glocal remap Viterbi against the same scores, and each base's
    error probability is read off that alignment as for a Viterbi path.
    Returns (path, qstring or None)."""
    from taiyaki_tpu_torch import decodeutil, flipflop_remap, qscores
    from taiyaki_tpu_torch.flipflopfings import nbase_flipflop, path_to_str
    best_path, _ = decodeutil.beamsearch(
        stitched_trans, beam_width=beam.width, guided=beam.guided)
    if not fastq:
        return best_path, None
    nbase = nbase_flipflop(stitched_trans.shape[1])
    seq_str = path_to_str(best_path, alphabet=alphabet[:nbase],
                          include_first_source=True)
    _, pos_path = flipflop_remap.flipflop_remap(
        stitched_trans, seq_str, alphabet=alphabet[:nbase])
    pos_path = np.clip(pos_path, 0, len(best_path) - 1)
    state_path = np.asarray(best_path)[pos_path]
    block_errprobs = qscores.errprobs_from_trans(
        stitched_trans[:, None, :], state_path[:, None])[:, 0]
    return best_path, qscores.path_errprobs_to_qstring(
        block_errprobs, state_path, qscore_scale, qscore_offset)


def select_devices(spec, ndevices):
    """The devices of --device `spec` and --ndevices: every card by
    default, one where `spec` is an index; `ndevices` replicas on the CPU
    with spec "cpu".  Exits where more cards are asked for than there
    are, or where a card is asked for and CUDA is not available."""
    if spec == "cpu":
        return [torch.device("cpu")] * (ndevices or 1)
    if ndevices is None and isinstance(spec, int):
        return [select_device(spec)]
    have = torch.cuda.device_count()
    if ndevices is not None and ndevices > have:
        sys.exit("* Error: --ndevices {} requested but only {} local "
                 "devices are available".format(ndevices, have))
    if ndevices == 1 or (ndevices is None and have <= 1):
        return [select_device(spec)]
    from taiyaki_tpu_torch.parallel.mesh import local_data_mesh
    return local_data_mesh()[:ndevices]


def main(argv=None, devices=None):
    """Run the basecaller on the devices of --device and --ndevices, or on
    `devices` (a list of torch devices, which may name a card more than
    once) where given; returns counts and wall time as a dict."""
    args = get_parser().parse_args(argv)
    if args.modified_base_output is not None and args.beam is not None:
        # the beam returns bases with no block alignment, so per-base mod
        # scores cannot be read off it
        sys.exit("* Error: --modified_base_output requires the Viterbi "
                 "decoder (drop --beam)")
    # f32 end to end: no TF32 in matrix products or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if devices is None:
        devices = select_devices(args.device, args.ndevices)
    device = devices[0]
    if len(devices) > 1:
        sys.stderr.write("* Sharding chunk batches over {} devices.\n"
                         .format(len(devices)))

    from taiyaki_tpu_torch import layers
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils, hdf5
    from taiyaki_tpu_torch.flipflopfings import nstate_flipflop
    from taiyaki_tpu_torch.utils import helpers

    sys.stderr.write("* Initializing reads file search.\n")
    fast5_reads = fast5utils.iterate_fast5_reads(
        args.input_folder, limit=args.limit,
        strand_list=args.input_strand_list, recursive=args.recursive)
    if args.scaling is not None:
        sys.stderr.write("* Loading read scaling parameters from {}.\n"
                         .format(args.scaling))
        from taiyaki_tpu_torch.prepare_mapping_funcs import (
            get_per_read_params_dict_from_tsv)
        all_read_params = get_per_read_params_dict_from_tsv(args.scaling)
        fast5_reads = [rec for rec in fast5_reads
                       if rec[1] in all_read_params]
    else:
        all_read_params = {}

    net, params, _, metadata, _, _ = helpers.load_model(args.model)
    if params is None:
        sys.exit("* Error: pass a .checkpoint (a model description .py has "
                 "no trained weights)")
    can_nmods = mod_writer = mod_reads = None
    if args.modified_base_output is not None:
        if not layers.is_cat_mod_model(net):
            sys.exit("* Error: --modified_base_output requires a cat_mod "
                     "model")
        head = net.sublayers[-1]
        can_nmods = head.can_nmods
        mod_writer = hdf5.Writer(args.modified_base_output)
        mod_writer.create_dataset(
            "mod_long_names",
            data=np.array([n.encode() for n in head.ordered_mod_long_names]))
        mod_reads = mod_writer.create_group("Reads")
    net = load_jax_params(net, params).eval()
    stride = net.stride
    chunk_size = args.chunk_size * stride
    overlap = args.overlap * stride
    caller = Basecaller(net, nstate_flipflop(len(args.alphabet)),
                        args.posterior, args.temperature,
                        args.max_concurrent_chunks, devices,
                        want_errprobs=args.fastq and args.beam is None,
                        want_trans=args.beam is not None,
                        want_mods=can_nmods is not None,
                        want_paths=args.beam is None)

    sys.stderr.write("* Calling reads on {}.\n".format(
        ", ".join(str(d) for d in devices)))
    nbase = ncalled = nread = nsample = 0
    t0 = time.time()
    progress = helpers.Progress(quiet=args.quiet)
    startcharacter = "@" if args.fastq else ">"
    pool = ThreadPoolExecutor(max_workers=max(1, args.jobs))

    def fetch(item):
        return item[0], item[1], get_signal(item[0], item[1])

    def bounded_prefetch(items, depth):
        """Ordered signals with at most `depth` fetches in flight."""
        q = deque()
        for item in items:
            q.append(pool.submit(fetch, item))
            if len(q) >= depth:
                yield q.popleft().result()
        while q:
            yield q.popleft().result()

    reverse_model = metadata.get("reverse", False)
    with torch.inference_mode(), \
            helpers.open_file_or_stdout(args.output) as fh:
        pending = []
        pend_chunks = 0
        # one batch in flight: flush() queues the current pool on the card
        # and then finalizes the previous batch on the host
        inflight = None

        def finalize_batch(batch_reads, handles):
            nonlocal nbase, ncalled, nsample
            paths, errprobs, mods, trans = caller.gather(handles)
            offs, off = [], 0
            for p in batch_reads:
                offs.append(off)
                off += p["chunks"].shape[1]

            def finalize_one(p, off):
                k = p["chunks"].shape[1]
                return finalize_read(
                    p, paths[:, off:off + k], errprobs[:, off:off + k],
                    chunk_size, stride, args.alphabet, args.fastq,
                    args.qscore_scale, args.qscore_offset,
                    mods[:, off:off + k], can_nmods, trans[:, off:off + k],
                    args.beam)

            for p, (basecall, qstring, mod_scores) in zip(
                    batch_reads, pool.map(finalize_one, batch_reads, offs)):
                nsample += p["nsample"]
                progress.step()
                if mod_scores is not None:
                    if p["read_id"] in mod_reads:
                        # one read in two input files: keep the first table
                        sys.stderr.write(
                            "* Warning: duplicate read id {}; keeping the "
                            "first mod-score table.\n".format(p["read_id"]))
                    else:
                        mod_reads.create_dataset(
                            p["read_id"], data=mod_scores.astype(np.float32))
                # a read id found twice gets a record for every copy, as
                # in bin/basecall.py
                if basecall is not None and len(basecall) > 0:
                    fh.write("{}{}\n{}\n".format(
                        startcharacter, p["read_id"],
                        basecall[::-1] if args.reverse else basecall))
                    nbase += len(basecall)
                    ncalled += 1
                    if args.fastq and qstring is not None:
                        fh.write("+\n{}\n".format(
                            qstring[::-1] if args.reverse else qstring))

        def flush():
            nonlocal inflight, pend_chunks
            batch = None
            if pending:
                all_chunks = np.concatenate(
                    [p["chunks"] for p in pending], axis=1)
                batch = (list(pending), caller.submit(all_chunks))
                pending.clear()
                pend_chunks = 0
            if inflight is not None:
                finalize_batch(*inflight)
            inflight = batch

        for _, read_id, signal in bounded_prefetch(
                fast5_reads, depth=max(4, 2 * args.jobs)):
            nread += 1
            prep = prepare_read(read_id, signal, chunk_size, overlap,
                                all_read_params.get(read_id), reverse_model)
            if prep is None:
                progress.step()
                continue
            pending.append(prep)
            pend_chunks += prep["chunks"].shape[1]
            if pend_chunks >= args.max_concurrent_chunks:
                flush()
        flush()   # queue the tail pool, finalize the previous batch
        flush()   # finalize the tail batch
    pool.shutdown()
    if mod_writer is not None:
        mod_writer.close()
    total_time = time.time() - t0
    sys.stderr.write("* Called {} reads in {:.2f}s\n".format(
        nread, total_time))
    sys.stderr.write("* {:7.2f} kbase / s\n".format(
        nbase / total_time / 1000.0))
    sys.stderr.write("* {:7.2f} ksample / s\n".format(
        nsample / total_time / 1000.0))
    sys.stderr.write("* {} reads failed.\n".format(nread - ncalled))
    return dict(nread=nread, ncalled=ncalled, nbase=nbase, nsample=nsample,
                seconds=total_time, device=str(device))


if __name__ == "__main__":
    main()
