"""Model load/save, progress and output helpers (port of
taiyaki_tpu/utils/helpers.py).

Checkpoints keep the JAX package's format, so one file loads in both
packages: a pickled dict
    {"model_source": <text of the model description .py file>,
     "model_kwargs": <factory kwargs>,
     "params": <numpy pytree>,
     "optimizer_state": <optimizer state or None>,
     "metadata": {"reverse": ..., "standardize": ..., "version": 3}}
whose model source imports from `taiyaki_tpu`.  The port executes that
text with an `__import__` that maps `taiyaki_tpu` to `taiyaki_tpu_torch`
(the stored text is not rewritten, and `taiyaki_tpu` is never imported),
and unpickles with a restricted Unpickler that admits numpy arrays and
plain builtin containers only, and optax's optimizer-state classes as
`OptaxState` tuples that keep their fields (the card's host has no optax);
anything else becomes a placeholder, with a warning, since basecalling
needs only `params`.  `save_model` writes `OptaxState`s back as the optax
classes they stand for, without importing optax, so that the JAX trainer
resumes the port's optimizer state.
"""

import builtins
import hashlib
import os
import pickle
import platform
import re
import sys
import time
import types
import warnings

import numpy as np

from taiyaki_tpu_torch import MODEL_VERSION, __version__
from taiyaki_tpu_torch.alphabet import AlphabetInfo


# -- model description loading ----------------------------------------------

_JAX_PKG = "taiyaki_tpu"
_PORT_PKG = "taiyaki_tpu_torch"


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == _JAX_PKG or name.startswith(_JAX_PKG + ".")):
        name = _PORT_PKG + name[len(_JAX_PKG):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _exec_model_source(source, name="netmodule"):
    """Build a module object from model-description source text, with
    imports of `taiyaki_tpu` served by `taiyaki_tpu_torch`."""
    module = types.ModuleType(name)
    module.__dict__["__builtins__"] = dict(vars(builtins),
                                           __import__=_port_import)
    exec(compile(source, name, "exec"), module.__dict__)
    return module


def canonical_source(source):
    """Model source as checkpoints store it: importing from `taiyaki_tpu`,
    so that the JAX package loads the checkpoint as well."""
    return re.sub(r"\b{}\b".format(_PORT_PKG), _JAX_PKG, source)


def _alphabet_to_spec(alphabet_info):
    if alphabet_info is None:
        return None
    return {"alphabet": alphabet_info.alphabet,
            "collapse_alphabet": alphabet_info.collapse_alphabet,
            "mod_long_names": alphabet_info.mod_long_names}


def _spec_to_alphabet(spec):
    if spec is None:
        return None
    return AlphabetInfo(spec["alphabet"], spec["collapse_alphabet"],
                        spec["mod_long_names"])


def new_model(model_file, model_metadata=None, **model_kwargs):
    """Build a network from a model-description .py file.

    Returns:
        (network, model_source, metadata); the source is canonical (see
        `canonical_source`).  Weights are zero: draw them with
        `convert.load_jax_params(network, network.init(numpy_rng))`.
    """
    with open(model_file) as fh:
        source = canonical_source(fh.read())
    network = _exec_model_source(source).network(**model_kwargs)
    metadata = dict(model_metadata or {})
    metadata["version"] = MODEL_VERSION
    return network, source, metadata


class OptaxState(tuple):
    """One of optax's optimizer-state NamedTuples, held without optax: its
    fields in order, and the class it stands for (`optax_module`,
    `optax_name`).  Pickles as that class (`save_model`)."""
    __slots__ = ()
    optax_module = optax_name = None

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "{}{}".format(self.optax_name, tuple.__repr__(self))


_OPTAX_CLASSES = {}


def optax_class(module, name):
    """The `OptaxState` subclass standing for optax's `module`.`name`."""
    key = (module, name)
    if key not in _OPTAX_CLASSES:
        _OPTAX_CLASSES[key] = type(name, (OptaxState,), {
            "__slots__": (), "optax_module": module, "optax_name": name})
    return _OPTAX_CLASSES[key]


class _CheckpointPickler(pickle._Pickler):
    """pickle's own Python pickler, writing each `OptaxState` class as a
    reference to the optax class it stands for: stock pickle imports a
    class before it names one, and optax is not installed everywhere."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, OptaxState) \
                and obj.optax_module is not None:
            self.write(pickle.GLOBAL + "{}\n{}\n".format(
                obj.optax_module, obj.optax_name).encode("utf-8"))
            self.memoize(obj)
            return
        super().save_global(obj, name)


def checkpoint_name(index=None):
    """model_final (index None) or model_checkpoint_XXXXX: the base name
    of a checkpoint's .checkpoint and .params files."""
    return ("model_final" if index is None
            else "model_checkpoint_{:05d}".format(index))


def save_model(outdir, network, params, model_source, model_kwargs,
               metadata, index=None, optimizer_state=None):
    """Write model_final.checkpoint (index None) or
    model_checkpoint_XXXXX.checkpoint, plus .params with the raw parameter
    pytree, under outdir.  `params` is the numpy pytree
    (`convert.params_to_jax(network)`); `optimizer_state` an optax state of
    `OptaxState`s (`train.Optimizer.jax_state`) or None."""
    basename = checkpoint_name(index)
    ckpt = {
        "model_source": canonical_source(model_source),
        "model_kwargs": dict(model_kwargs,
                             alphabet_info=_alphabet_to_spec(
                                 model_kwargs.get("alphabet_info"))),
        "params": params,
        "optimizer_state": optimizer_state,
        "metadata": dict(metadata),
    }
    model_file = os.path.join(outdir, basename + ".checkpoint")
    with open(model_file, "wb") as fh:
        _CheckpointPickler(fh, pickle.DEFAULT_PROTOCOL).dump(ckpt)
    with open(os.path.join(outdir, basename + ".params"), "wb") as fh:
        pickle.dump(params, fh)
    return model_file


_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "str", "bytes", "bytearray", "bool",
                  "slice", "range"}
_SAFE_NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}


class _CheckpointUnpickler(pickle.Unpickler):
    """Admits numpy arrays, dtypes and builtin containers, and optax's
    classes as `OptaxState`s; every other class becomes a placeholder."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if (module == "builtins" and name in _SAFE_BUILTINS) \
                or (module == "collections" and name == "OrderedDict") \
                or (root == "numpy" and (name in _SAFE_NUMPY
                                         or module == "numpy.dtypes")):
            return super().find_class(module, name)
        if root == "optax":
            return optax_class(module, name)
        warnings.warn("checkpoint holds {}.{}; loaded as a placeholder "
                      "(basecalling needs only the parameters)".format(
                          module, name), RuntimeWarning)
        return _placeholder(module, name)


def _placeholder(module, name):
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state
    return type("Unloaded_" + name, (), {
        "__init__": __init__, "__setstate__": __setstate__,
        "__module__": __name__,
        "__doc__": "Stands in for {}.{}".format(module, name)})


def _unpickle(path):
    with open(path, "rb") as fh:
        return _CheckpointUnpickler(fh).load()


def load_model(model_file, params_file=None, model_metadata=None,
               **model_kwargs):
    """Load a model from a .py description (no weights) or a .checkpoint.

    Returns:
        (network, params_or_None, model_source, metadata, model_kwargs,
         optimizer_state_or_None); `params` is the numpy pytree, which
        `convert.load_jax_params` puts into `network`.
    """
    _, extension = os.path.splitext(model_file)
    if extension == ".py":
        network, source, metadata = new_model(
            model_file, model_metadata, **model_kwargs)
        return network, None, source, metadata, model_kwargs, None

    ckpt = _unpickle(model_file)
    metadata = ckpt["metadata"]
    if metadata.get("version") != MODEL_VERSION:
        raise ValueError("Attempted to load a checkpoint with model version "
                         "{} (expected {})".format(metadata.get("version"),
                                                   MODEL_VERSION))
    if model_metadata is not None:
        for key in ("reverse", "standardize"):
            if key in model_metadata and metadata.get(key) != \
                    model_metadata[key]:
                sys.stderr.write(
                    "* WARNING: Model and model_metadata {} are "
                    "inconsistent.\n".format(key))
                warnings.warn("Inconsistent metadata", RuntimeWarning)
                metadata[key] = model_metadata[key]
    kwargs = dict(ckpt["model_kwargs"])
    kwargs["alphabet_info"] = _spec_to_alphabet(kwargs.get("alphabet_info"))
    network = _exec_model_source(ckpt["model_source"]).network(**kwargs)
    params = ckpt["params"]
    if params_file is not None:
        params = _unpickle(params_file)
    return (network, params, ckpt["model_source"], metadata, kwargs,
            ckpt.get("optimizer_state"))


def guess_model_stride(net):
    """Total time stride of a network, from its output's length on a zero
    input (`layers.guess_model_stride`); the weights, loaded or not, do not
    change it."""
    from taiyaki_tpu_torch import layers
    return layers.guess_model_stride(net)


# -- progress / output --------------------------------------------------------

COLOURS = [91, 93, 95, 92, 35, 33, 94]


class Progress:
    """Coloured dot-per-unit progress indicator."""

    def __init__(self, fh=sys.stderr, every=1, maxlen=50, quiet=False):
        assert every > 0
        self.count = 0
        self.every = every
        self._maxlen = maxlen
        self.fh = fh
        self.quiet = quiet

    def step(self):
        self.count += 1
        if self.quiet:
            return
        if self.count % self.every == 0:
            dotcount = self.count // self.every
            self.fh.write("\033[1;{}m.\033[m".format(
                COLOURS[dotcount % len(COLOURS)]))
            if dotcount % self._maxlen == 0:
                self.fh.write("{:8d}\n".format(self.count))
            self.fh.flush()


class _StdoutGuard:
    """Context manager around sys.stdout that does not close it on exit."""

    def __enter__(self):
        return sys.stdout

    def __exit__(self, *exc):
        sys.stdout.flush()
        return False


def open_file_or_stdout(filename):
    """Open a file for writing, or a non-closing stdout wrapper for
    None/'-'."""
    if filename is None or filename == "-":
        return _StdoutGuard()
    return open(filename, "w")


# -- training logs -------------------------------------------------------------

class WindowedExpSmoother:
    """Exponentially-weighted average over a fixed window of the newest
    values."""

    def __init__(self, alpha=0.95, n_vals=100):
        assert 0.0 <= alpha <= 1.0
        self.alpha = alpha
        self.weights = np.power(alpha, np.arange(n_vals))
        self.vals = np.full(n_vals, np.nan)
        self.n_valid = 0

    @property
    def value(self):
        if self.n_valid == 0:
            return np.nan
        n = min(self.n_valid, len(self.vals))
        return np.average(self.vals[:n], weights=self.weights[:n])

    def update(self, val):
        self.vals[1:] = self.vals[:-1]
        self.vals[0] = val
        self.n_valid += 1


class Logger:
    """Tee log messages to an unbuffered file and stdout."""

    def __init__(self, log_file_name=None, quiet=False):
        self.fh = (None if log_file_name is None
                   else open(log_file_name, "wb", 0))
        self.quiet = quiet

    def write(self, message):
        if not self.quiet:
            sys.stdout.write(message)
            sys.stdout.flush()
        if self.fh is not None:
            self.fh.write(message.encode("utf-8"))

    def close(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None


def file_md5(filename, nblock=1024):
    """MD5 hex digest of a file."""
    hasher = hashlib.md5()
    block_size = nblock * hasher.block_size
    with open(filename, "rb") as fh:
        for blk in iter(lambda: fh.read(block_size), b""):
            hasher.update(blk)
    return hasher.hexdigest()


def prepare_outdir(outdir, overwrite=False):
    """Create the output directory; refuse to reuse one unless
    overwrite."""
    if os.path.exists(outdir):
        if not overwrite:
            sys.exit("Output directory {} exists — use --overwrite to "
                     "proceed".format(outdir))
        if not os.path.isdir(outdir):
            raise NotADirectoryError(
                "{} exists and is not a directory".format(outdir))
    else:
        os.makedirs(outdir, exist_ok=True)


def formatted_env_info(device):
    """Provenance header for model.log."""
    import torch
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else platform.processor() or "cpu")
    lines = [
        "* Taiyaki-TPU (PyTorch port) version {}".format(__version__),
        "* Platform is {}".format(platform.platform()),
        "* Python is {}".format(sys.executable),
        "* Python version is {}".format(sys.version.replace("\n", " ")),
        "* PyTorch version {} (CUDA {})".format(torch.__version__,
                                               torch.version.cuda),
        "* Using device {} ({})".format(device, name),
        "* Command line:",
        "* \"" + " ".join(sys.argv) + "\"",
        "* Started on {}".format(time.strftime("%c")),
    ]
    return "\n".join(lines) + "\n"
