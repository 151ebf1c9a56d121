"""Remapping of raw reads to their references with a flip-flop network, for
training data (port of taiyaki_tpu/prepare_mapping_funcs.py).

A read is staged on the host (fast5 signal, trimmed and standardized by
its per-read parameters), goes through the network's forward on a
torch.device, and is finished on the host: the glocal Viterbi of
`flipflop_remap` against its collapsed reference gives a path, which
`SignalMapping.from_remapping_path` turns into the read's mapping.

Padding changes the answer: the JAX package pads every signal with zeros
up to a multiple of LEN_BUCKET samples before the forward and keeps the
first ceil(siglen / stride) blocks.  The remap models hold Reverse layers,
so the padded zeros set the state in which the reversed layers enter the
read's last real block.  The port pads in exactly the same way, on the
per-read path and on the batched one, or its mappings would not be the
JAX package's.
"""

import enum
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from taiyaki_tpu_torch import flipflop_remap
from taiyaki_tpu_torch.data import signal as signal_mod
from taiyaki_tpu_torch.data import signal_mapping
from taiyaki_tpu_torch.data.fast5utils import get_fast5_file
from taiyaki_tpu_torch.data.mapped_signal_files import MappedSignalWriter
from taiyaki_tpu_torch.utils import helpers
from taiyaki_tpu_torch.utils.fileio import readtsv

# Signal length quantum of the remapping forward (see the module docstring)
LEN_BUCKET = 2048


class RemapResult(enum.Enum):
    """Outcomes of remapping one read."""
    SUCCESS = "Success!"
    READ_ID_INFO_NOT_FOUND = "No information for read id found in file."
    NO_REF_FOUND = "No fasta reference found."
    NO_PARAMS = "No per-read params provided."
    NETWORK_ERROR = "Failure applying basecall network to remap read."
    REF_TOO_LONG = "Reference exceeded maximum allowed read length."


def padded_length(siglen):
    """The signal length a read is zero-padded to before its forward:
    padding changes the answer, so it is the JAX package's (see the module
    docstring)."""
    return -(-siglen // LEN_BUCKET) * LEN_BUCKET


def forward(net, batch, device):
    """Network output [T, B, nout] (numpy f32) of a signal batch
    [L, B, 1] (numpy f32) on `device`."""
    with torch.inference_mode():
        out = net(torch.from_numpy(batch).to(device))
        return out.float().cpu().numpy()


def stage_read(read_tuple, per_read_params_dict, max_read_length):
    """Host IO half of remapping: validate, load and standardize the
    signal.

    Returns:
        (staged dict, None) on success, else (None, RemapResult).
    """
    filename, read_id, read_ref = read_tuple
    if read_ref is None:
        return None, RemapResult.NO_REF_FOUND
    if max_read_length is not None and len(read_ref) > max_read_length:
        return None, RemapResult.REF_TOO_LONG
    try:
        read_params = per_read_params_dict[read_id]
    except KeyError:
        return None, RemapResult.NO_PARAMS

    try:
        with get_fast5_file(filename) as f5:
            read = f5.get_read(read_id)
            sig = signal_mod.Signal(read, read_params=read_params)
    except Exception:
        return None, RemapResult.READ_ID_INFO_NOT_FOUND
    return {
        "sig": sig,
        "current": sig.standardized_current.astype(np.float32),
        "read_ref": read_ref,
    }, None


def finish_remap(staged, transweights, alphabet_info, stride, localpen):
    """Host half after the forward: glocal Viterbi against the collapsed
    reference, then the read's SignalMapping as a dict."""
    read_ref = staged["read_ref"]
    can_read_ref = alphabet_info.collapse_sequence(read_ref)
    _, path = flipflop_remap.flipflop_remap(
        transweights, can_read_ref, alphabet=alphabet_info.can_bases,
        localpen=localpen)

    int_ref = signal_mapping.SignalMapping.get_integer_reference(
        read_ref, alphabet_info.alphabet)
    sig_mapping = signal_mapping.SignalMapping.from_remapping_path(
        path, int_ref, stride, staged["sig"])
    try:
        return sig_mapping.get_read_dictionary(), RemapResult.SUCCESS
    except signal_mapping.TaiyakiSigMapError as e:
        return None, str(e)


def oneread_remap(read_tuple, net, per_read_params_dict, alphabet_info,
                  max_read_length, localpen=0.0):
    """Remap one read on the CPU (the worker of imap_mp on the CPU path).

    Args:
        read_tuple: (filename, read_id, read reference string or None).
        net: the remapping network (the port's module, weights loaded).
        per_read_params_dict: read_id -> {trim_start, trim_end, shift,
            scale}.
        alphabet_info: full (possibly modified-base) alphabet.
        max_read_length: skip reads with references longer than this.
        localpen: local-alignment penalty (0.0 = local).

    Returns:
        (read dict or None, RemapResult or error string)
    """
    staged, err = stage_read(read_tuple, per_read_params_dict,
                             max_read_length)
    if staged is None:
        return None, err

    stride = net.stride
    siglen = len(staged["current"])
    padded = np.zeros((padded_length(siglen), 1, 1), dtype=np.float32)
    padded[:siglen, 0, 0] = staged["current"]
    try:
        out = forward(net, padded, "cpu")
    except Exception:
        return None, RemapResult.NETWORK_ERROR
    nblk = -(-siglen // stride)
    return finish_remap(staged, out[:nblk, 0], alphabet_info, stride,
                        localpen)


def batched_remap_results(read_tuples, net, per_read_params_dict,
                          alphabet_info, max_read_length, localpen=0.0,
                          batch_size=8, io_threads=4, timings=None):
    """Remap reads with batched forwards on one device, in one process.

    An IO thread pool stages the reads; they are grouped into pools of one
    padded length, forwarded `batch_size` at a time (a batch holds
    `batch_size` columns, unused ones zero) and finished on the host in
    stream order.  A pool flushes when it holds `batch_size` reads; the
    pools left at the end flush in order of padded length, so the output
    order follows from the lengths.  Yields (read dict or None, RemapResult
    or error string) as imap_mp(oneread_remap, ...) does.

    Mappings agree with the per-read path but at near-tie Viterbi
    boundaries: a forward of 8 columns and one of 1 can round differently,
    and where the scores plateau (signal stalls) a boundary can move by
    several blocks.

    No fork happens here: `io_threads` are threads, so the card may be
    initialised.  The forward runs where the network's weights lie.  The
    JAX package turns any exception of the forward into NETWORK_ERROR for
    every read of the batch; the port does so only for a network on the
    CPU.  For one on a card, an error of the forward (CUDA, a kernel's
    build or launch) is not the reads' fault and propagates.

    timings, where given, is a dict that gains the seconds spent waiting
    for staged reads ("stage"), in the forwards including their copy back
    to the host ("forward") and in the host finish ("finish").
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    device = next(net.parameters()).device
    on_card = device.type != "cpu"
    stride = net.stride
    clock = {} if timings is None else timings
    for key in ("stage", "forward", "finish"):
        clock.setdefault(key, 0.0)

    def flush(padded_len, items):
        """Forward one pool; yields its reads' results."""
        t0 = time.perf_counter()
        # batch_size columns whatever the pool holds, unused ones zero: the
        # batch layout is part of the contract (near ties round by it)
        batch = np.zeros((padded_len, batch_size, 1), dtype=np.float32)
        for j, st in enumerate(items):
            batch[:len(st["current"]), j, 0] = st["current"]
        try:
            out = forward(net, batch, device)
        except Exception:
            if on_card:
                raise
            for st in items:
                yield None, RemapResult.NETWORK_ERROR
            return
        t1 = time.perf_counter()
        clock["forward"] += t1 - t0
        for j, st in enumerate(items):
            nblk = -(-len(st["current"]) // stride)
            t1 = time.perf_counter()
            res = finish_remap(st, out[:nblk, j], alphabet_info, stride,
                               localpen)
            clock["finish"] += time.perf_counter() - t1
            yield res

    # a bounded window of staging futures: memory stays constant however
    # many reads the iterator holds
    pool = ThreadPoolExecutor(max_workers=max(1, io_threads))
    window = max(2 * batch_size, 4 * max(1, io_threads))
    pending = deque()
    read_iter = iter(read_tuples)

    def top_up():
        while len(pending) < window:
            try:
                rt = next(read_iter)
            except StopIteration:
                return
            pending.append(pool.submit(
                stage_read, rt, per_read_params_dict, max_read_length))

    pools = defaultdict(list)
    try:
        top_up()
        while pending:
            t0 = time.perf_counter()
            staged, err = pending.popleft().result()
            clock["stage"] += time.perf_counter() - t0
            top_up()
            if staged is None:
                yield None, err
                continue
            padded_len = padded_length(len(staged["current"]))
            pools[padded_len].append(staged)
            if len(pools[padded_len]) == batch_size:
                yield from flush(padded_len, pools.pop(padded_len))
        for padded_len, items in sorted(pools.items()):
            yield from flush(padded_len, items)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def generate_output_from_results(results, output, alphabet_info,
                                 verbose=True, batch_format=True):
    """Stream results into a mapped-signal file, tallying failures on
    stderr; returns (reads written, {failure: count})."""
    progress = helpers.Progress(quiet=not verbose)
    err_types = defaultdict(int)
    with MappedSignalWriter(output, alphabet_info, batch_format) as msw:
        for resultdict, mesg in results:
            if resultdict is None:
                err_types[mesg] += 1
            else:
                progress.step()
                msw.write_read(resultdict)
    sys.stderr.write("\n")
    sys.stderr.write("* {} reads mapped successfully\n".format(
        progress.count))
    for result, n_errs in err_types.items():
        desc = result.value if isinstance(result, RemapResult) else result
        sys.stderr.write("* {} reads failed to produce remapping results "
                         "due to: {}\n".format(n_errs, desc))
    return progress.count, dict(err_types)


def get_per_read_params_dict_from_tsv(input_file):
    """Load the per-read params TSV (UUID, trim_start, trim_end, shift,
    scale) into a dict keyed by UUID."""
    try:
        table = readtsv(input_file, ["UUID", "trim_start", "trim_end",
                                     "shift", "scale"])
    except Exception as e:
        sys.stderr.write("Failed to get per-read parameters from {}.\n{}\n"
                         .format(input_file, repr(e)))
        return None
    out = {}
    for row in table:
        try:
            out[str(row["UUID"])] = {
                "trim_start": int(row["trim_start"]),
                "trim_end": int(row["trim_end"]),
                "shift": float(row["shift"]),
                "scale": float(row["scale"])}
        except Exception:
            sys.stderr.write("Warning: ignoring incorrect line {} in {}\n"
                             .format(tuple(row), input_file))
    return out
