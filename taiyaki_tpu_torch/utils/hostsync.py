"""Cross-rank integer reductions off the gradient group's channel (port
of taiyaki_tpu/utils/hostsync.py).

Multi-process training with --seqlen_buckets pads each sub-batch's
sequences to a length that every rank must agree on (the global max of
the sampled lengths, `train.sample_batch`'s seqlen_reduce), and each
rank's loss divides by the global count of rows with a sequence.  Both
are reduced on the trainer's prefetch thread, while the main thread runs
the gradient all-reduces.  Collectives on one group issued from two
threads in different orders on different ranks deadlock, so these never
share the gradient group: `start()`, on the main thread before any
sampling, makes a gloo group of their own, which only the sampler thread
then uses.

Each reduction all-gathers (value, tag checksum) from every rank: tags
must be issued in the same order on every rank (the trainer uses
"iteration.sub_batch"), and a rank that issued another tag makes every
rank raise.  A peer that dies breaks gloo's connection, which fails the
reduction at once; the reducer then refuses every later one.
"""

import datetime
import threading
import zlib

import torch


class MaxReducer:
    """`reduce(tag, value)` -> the max over ranks, `total(tag, value)` ->
    the sum, on a process group that only this object uses.  Thread-safe
    (a lock serialises the reductions)."""

    def __init__(self, group):
        self._group = group
        self._lock = threading.Lock()
        self._poisoned = None   # RuntimeError once a reduction failed

    def gather(self, tag, value):
        """Every rank's `value` (an int) for `tag`, in rank order."""
        import torch.distributed as dist
        assert " " not in tag and "\n" not in tag, tag
        mine = torch.tensor([int(value), zlib.crc32(tag.encode())],
                            dtype=torch.int64)
        with self._lock:
            if self._poisoned is not None:
                raise self._poisoned
            out = [torch.empty_like(mine)
                   for _ in range(dist.get_world_size(self._group))]
            try:
                dist.all_gather(out, mine, group=self._group)
            except RuntimeError as e:
                self._poisoned = RuntimeError(
                    "seqlen-sync: a peer's connection was lost ({}); the "
                    "job cannot continue: restart every rank".format(e))
                raise self._poisoned from e
        if any(int(t[1]) != int(mine[1]) for t in out):
            raise RuntimeError("seqlen-sync tag mismatch: this rank sent "
                               "{!r}, another a different tag".format(tag))
        return [int(t[0]) for t in out]

    def reduce(self, tag, value):
        return max(self.gather(tag, value))

    def total(self, tag, value):
        return sum(self.gather(tag, value))


def start(timeout=120.0):
    """The job's reducer, on a gloo group of its own.  Call on the main
    thread of every rank, in the same order relative to the other groups
    they make, after torch.distributed is initialised."""
    import torch.distributed as dist
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout))
    return MaxReducer(group)
