"""Multiprocess mapping helpers (reference: taiyaki/iterators.py:66-124).

imap_mp is the host-side parallelism workhorse for remapping, per-read
parameter estimation and basecalling: a generator wrapping
multiprocessing.Pool.imap[_unordered] with fixed args applied via partial.
"""

from functools import partial
from multiprocessing import Pool


def imap_mp(function, args, fix_args=None, fix_kwargs=None, threads=1,
            unordered=False, chunksize=1, init=None, initargs=()):
    """Parallel (or serial for threads=1) map as a generator.

    Args:
        function: picklable function of (item, *fix_args, **fix_kwargs).
        args: iterable of items.
        fix_args / fix_kwargs: constant extra arguments.
        threads: number of worker processes (1 = run in-process).
        unordered: yield in completion order instead of input order.
        chunksize: items per worker dispatch.
        init / initargs: per-worker initializer.
    """
    fix_args = tuple(fix_args or ())
    fix_kwargs = dict(fix_kwargs or {})

    if threads == 1:
        if init is not None:
            init(*initargs)
        for item in args:
            yield function(item, *fix_args, **fix_kwargs)
        return

    bound = partial(_apply, function, fix_args, fix_kwargs)
    with Pool(threads, initializer=init, initargs=initargs) as pool:
        mapper = pool.imap_unordered if unordered else pool.imap
        yield from mapper(bound, args, chunksize=chunksize)


def _apply(function, fix_args, fix_kwargs, item):
    return function(item, *fix_args, **fix_kwargs)


def try_except_pass(func, *args, **kwargs):
    """Call func, returning None on any exception — with the traceback
    printed to stderr first (reference iterators.py: silent failures in
    worker pipelines are undebuggable otherwise)."""
    try:
        return func(*args, **kwargs)
    except Exception:
        import sys
        import traceback
        sys.stderr.write(traceback.format_exc())
        return None


def empty_iterator(it):
    """(is_empty, iterator) — the reference contract (used by
    fileio.read_chunks): peeks via itertools.chain so NO element is
    lost from the returned iterator."""
    import itertools
    try:
        first = next(it)
    except StopIteration:
        return True, it
    return False, itertools.chain([first], it)
