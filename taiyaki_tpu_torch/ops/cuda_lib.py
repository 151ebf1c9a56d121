"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a (Hopper) into its own shared library, loaded with
ctypes.  The build happens at first use, into `_build/` beside this
package's sources (listed in .gitignore) or into $TAIYAKI_TORCH_BUILD_DIR;
a library is named after a hash of its source and flags, so an edited
source builds anew and an unchanged one is reused.  All sources are
compiled at once, one nvcc process each.

Nothing here runs at import time: the CPU tests import every module on
machines with no nvcc and no card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
SOURCES = ("lstm", "logz", "crf", "gru", "gemm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def build_dir():
    return os.environ.get("TAIYAKI_TORCH_BUILD_DIR",
                          os.path.join(PKG_DIR, "_build"))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    for path in sorted([src] + [os.path.join(CSRC_DIR, f)
                                for f in os.listdir(CSRC_DIR)
                                if f.endswith(".cuh")]):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(build_dir(),
                             "{}-{}.so".format(name, h.hexdigest()[:16]))


def build_all():
    """Compile every source whose library is missing, all in parallel.
    Returns {name: library path}; raises with nvcc's output on failure.
    The compiler's report (registers, spills) is kept in <library>.log."""
    os.makedirs(build_dir(), exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t[1])}
    nvcc = _nvcc() if todo else None
    procs = {}
    for name, (src, out) in todo.items():
        tmp = "{}.{}.tmp".format(out, os.getpid())
        log = open(out + ".log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-o", tmp, src],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            with open(out + ".log") as fh:
                failed.append("{} (nvcc exit {}):\n{}".format(
                    name, rc, fh.read()[-4000:]))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def load(name, signatures):
    """The ctypes library built from csrc/<name>.cu (built on first use),
    with `signatures` {function: [argument ctypes]} declared on it; every
    function returns a CUDA error code (int)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_all()[name])
            lib.tt_error_string.restype = ctypes.c_char_p
            lib.tt_error_string.argtypes = [ctypes.c_int]
            for fn, argtypes in signatures.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def check(lib, err, what):
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, err, lib.tt_error_string(err).decode()))


P, I = ctypes.c_void_p, ctypes.c_int   # pointer / stream, int


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError("{}: tensors must be on the CPU (plain twin) or a "
                         "CUDA device, not {}".format(what, t.device))
