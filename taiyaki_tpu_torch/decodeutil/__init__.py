"""Host decoders in C++: the prefix beam search, the forward and backward
partition scans it is guided by, and the glocal remap Viterbi (the port's
copies of taiyaki_tpu/decodeutil's beamsearch.cpp and remapviterbi.cpp,
same C interface, loaded with ctypes).

The shared library is built with g++ at first use into the port's build
directory (`ops.cuda_lib.build_dir()`, `taiyaki_tpu_torch/_build/` by
default), never beside the sources, under a name hashed from the sources,
the flags and the host's processor (`-march=native` builds for it), so an
edited source or another host builds anew.  Each build writes a name of
its own process and renames it into place, so racing first uses never
load a partial library.  A failed build raises with the compiler's
output.  The scores are float32 numpy arrays on the host.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from taiyaki_tpu_torch.flipflopfings import nbase_flipflop
from taiyaki_tpu_torch.ops.cuda_lib import build_dir

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, name)
         for name in ("beamsearch.cpp", "remapviterbi.cpp")]
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


def _host_cpu():
    """The processor's model name and instruction-set flags (the first
    processor's, from /proc/cpuinfo), or the machine type."""
    found = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = value.strip()
    except OSError:
        pass
    return " ".join([platform.machine()] + [found[k] for k in sorted(found)])


def _lib_path():
    h = hashlib.sha256(" ".join(_FLAGS + [_host_cpu()]).encode())
    for path in _SRCS:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(),
                        "decodeutil-{}.so".format(h.hexdigest()[:16]))


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    r = subprocess.run(["g++"] + _FLAGS + ["-o", tmp] + _SRCS,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("decodeutil build failed (g++ exit {}):\n{}"
                           .format(r.returncode, r.stderr[-4000:]))
    os.replace(tmp, path)


def library():
    """The loaded library (ctypes), built first if this host has none;
    every decoder below calls it."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tt_flipflop_beamsearch.restype = ctypes.c_float
        lib.tt_flipflop_beamsearch.argtypes = [
            f32p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, i8p]
        for fn in (lib.tt_flipflop_forward, lib.tt_flipflop_backward):
            fn.restype = ctypes.c_float
            fn.argtypes = [f32p, ctypes.c_size_t, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_void_p]
        lib.tt_flipflop_remap_viterbi.restype = ctypes.c_double
        lib.tt_flipflop_remap_viterbi.argtypes = [
            f32p, ctypes.c_size_t, ctypes.c_size_t, i32p, i32p,
            ctypes.c_size_t, ctypes.c_double, i32p]
        _LIB = lib
        return lib


def _scan(fn, score, init):
    score = np.ascontiguousarray(score, dtype=np.float32)
    nt, nf = score.shape
    nbase = nbase_flipflop(nf)
    out = np.zeros((nt + 1, 2 * nbase), dtype=np.float32)
    init_ptr = None
    if init is not None:
        init = np.ascontiguousarray(init, dtype=np.float32)
        if init.shape != (2 * nbase,):
            raise ValueError("init has shape {}, want ({},)".format(
                init.shape, 2 * nbase))
        init_ptr = init.ctypes.data
    logz = fn(library())(score, nbase, nt, out.ctypes.data, init_ptr)
    return out, float(logz)


def forward(score, init=None):
    """Forward partition scan.

    Args:
        score: [nblock, nstate] float32 transition scores.
        init: optional [2*nbase] initial boundary scores (None = zeros).

    Returns:
        ([nblock + 1, 2*nbase] absolute boundary scores, log partition)
    """
    return _scan(lambda lib: lib.tt_flipflop_forward, score, init)


def backward(score, init=None):
    """Backward partition scan; `init` optionally seeds the final boundary
    (None = zeros).  Rows are absolute, so fwd[t] + bwd[t] composes."""
    return _scan(lambda lib: lib.tt_flipflop_backward, score, init)


def beamsearch(score, beam_cut=0.0, beam_width=5, guided=True):
    """Prefix beam search over flip-flop transition scores.

    Args:
        score: [nblock, nstate] float32 (log-space) transition scores.
        beam_cut: discard extensions more than this much worse (log space)
            than the current best; 0.0 disables cutting.
        beam_width: maximum number of beam elements.
        guided: rank extensions using backward scores.

    Returns:
        (sequence of flip-flop states as int8 array, score)
    """
    score = np.ascontiguousarray(score, dtype=np.float32)
    nt, nf = score.shape
    nbase = nbase_flipflop(nf)
    lib = library()
    bwd = backward(score)[0] if guided else None
    seq = np.full(nt + 1, -1, dtype=np.int8)
    read_score = lib.tt_flipflop_beamsearch(
        score, nbase, nt, None if bwd is None else bwd.ctypes.data,
        int(beam_width), float(beam_cut), seq)
    end = np.nonzero(seq == -1)[0]
    seqlen = int(end[0]) if len(end) else nt + 1
    return seq[:seqlen], float(read_score)


def remap_viterbi(scores, stay_index, step_index, localpen):
    """Glocal flip-flop remap Viterbi for one read.

    Args:
        scores: [T, nstate] log-space transition scores.
        stay_index: [M] score columns for staying at each position.
        step_index: [M-1] score columns for moving to the next position.
        localpen: per-block cost of sitting in the start/end state.

    Returns:
        (score, path [T+1] int32 of sequence positions, -1 in start/end)
    """
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    stay_index = np.ascontiguousarray(stay_index, dtype=np.int32)
    step_index = np.ascontiguousarray(step_index, dtype=np.int32)
    T, nstate = scores.shape
    M = stay_index.shape[0]
    if step_index.shape[0] != M - 1:
        raise ValueError("step_index has {} entries for {} positions"
                         .format(step_index.shape[0], M))
    for idx in (stay_index, step_index):
        if idx.size and (idx.min() < 0 or idx.max() >= nstate):
            raise ValueError("score column out of range [0, {})".format(
                nstate))
    path = np.empty(T + 1, dtype=np.int32)
    score = library().tt_flipflop_remap_viterbi(
        scores, T, nstate, stay_index, step_index, M, float(localpen),
        path)
    return float(score), path
