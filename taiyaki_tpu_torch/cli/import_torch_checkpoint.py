"""Convert a reference taiyaki (torch) checkpoint into a checkpoint of this
format (port of misc/import_torch_checkpoint.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.import_torch_checkpoint \\
        reference.checkpoint out.checkpoint [--reference_repo DIR]

The reference checkpoint is a pickled torch module whose classes live in
the reference `taiyaki` package, so it is unpickled with that package on
the path (--reference_repo, a checkout of it; without it, taiyaki as
installed).  Only the modules' tensors
are read: no torch module runs.  The model source and parameters written
are the JAX tool's, and its model source imports from `taiyaki_tpu`, which
the port's loader serves with its own modules.
"""

import argparse
import pickle
import sys

import numpy as np

from taiyaki_tpu_torch import MODEL_VERSION


def get_parser():
    parser = argparse.ArgumentParser(
        description="Convert a reference (torch) checkpoint")
    parser.add_argument("input", help="reference .checkpoint (torch)")
    parser.add_argument("output", help="taiyaki_tpu .checkpoint")
    parser.add_argument(
        "--reference_repo", default=None,
        help="Checkout of the reference taiyaki package (default: taiyaki "
             "as installed)")
    return parser


def tolerant_torch_load(path, reference_repo):
    """Load a legacy taiyaki torch checkpoint across torch versions: the
    reference package from `reference_repo`, and RNN modules pickled by an
    older torch given the flat-weight names a newer one expects.  The
    RNN patch and the path entry hold only while the file loads."""
    import torch
    from torch.nn.modules import rnn as rnn_mod

    if not hasattr(np, "NAN"):
        np.NAN = np.nan   # the reference predates numpy 2

    def tolerant_setstate(self, d):
        torch.nn.Module.__setstate__(self, d)
        if not hasattr(self, "_flat_weights_names"):
            self._flat_weights_names = [
                n for group in self._all_weights for n in group]
        self._init_flat_weights()

    setstate = rnn_mod.RNNBase.__setstate__
    if reference_repo is not None:
        sys.path.insert(0, reference_repo)
    rnn_mod.RNNBase.__setstate__ = tolerant_setstate
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        rnn_mod.RNNBase.__setstate__ = setstate
        if reference_repo is not None:
            sys.path.remove(reference_repo)


def convert_layer(ref_layer):
    """Recursively convert a reference torch layer into (model-source
    fragment, params pytree)."""
    name = type(ref_layer).__name__

    def t2n(t):
        return np.ascontiguousarray(t.detach().cpu().numpy()
                                    .astype(np.float32))

    if name == "Serial":
        subs = [convert_layer(l) for l in ref_layer.sublayers]
        src = "layers.Serial([{}])".format(", ".join(s[0] for s in subs))
        return src, {"sublayers": [s[1] for s in subs]}
    if name == "Reverse":
        src, p = convert_layer(ref_layer.layer)
        return "layers.Reverse({})".format(src), {"layer": p}
    if name == "Residual":
        src, p = convert_layer(ref_layer.layer)
        return "layers.Residual({})".format(src), {"layer": p}
    if name == "Parallel":
        subs = [convert_layer(l) for l in ref_layer.sublayers]
        return ("layers.Parallel([{}])".format(
            ", ".join(s[0] for s in subs)),
            {"sublayers": [s[1] for s in subs]})
    if name == "Convolution":
        # non-default padding rides along, or the output length changes;
        # the reference keeps it as a ConstantPad1d module
        pad_mod = getattr(ref_layer, "pad", None)
        pad = (tuple(pad_mod.padding) if pad_mod is not None
               else (ref_layer.winlen // 2, (ref_layer.winlen - 1) // 2))
        default_pad = (ref_layer.winlen // 2, (ref_layer.winlen - 1) // 2)
        pad_src = "" if pad == default_pad else ", pad={}".format(pad)
        src = ("layers.Convolution({}, {}, {}, stride={}, "
               "has_bias={}{}, fun=activation.{})".format(
                   ref_layer.insize, ref_layer.size, ref_layer.winlen,
                   ref_layer.stride, ref_layer.has_bias, pad_src,
                   ref_layer.activation.__name__))
        p = {"W": t2n(ref_layer.conv.weight)}
        if ref_layer.has_bias:
            p["b"] = t2n(ref_layer.conv.bias)
        return src, p
    if name == "GruMod":
        has_bias = bool(getattr(ref_layer, "has_bias", True))
        src = "layers.GruMod({}, {}, has_bias={})".format(
            ref_layer.insize, ref_layer.size, has_bias)
        p = {"iW": t2n(ref_layer.cudnn_gru.weight_ih_l0),
             "sW": t2n(ref_layer.cudnn_gru.weight_hh_l0)}
        # the layer keeps a (zero, untrained) b leaf when has_bias=False
        p["b"] = (t2n(ref_layer.cudnn_gru.bias_ih_l0) if has_bias
                  else np.zeros(3 * ref_layer.size, dtype=np.float32))
        return src, p
    if name == "Lstm":
        has_bias = bool(getattr(ref_layer, "has_bias", True))
        src = "layers.Lstm({}, {}, has_bias={})".format(
            ref_layer.insize, ref_layer.size, has_bias)
        p = {"iW": t2n(ref_layer.lstm.weight_ih_l0),
             "sW": t2n(ref_layer.lstm.weight_hh_l0)}
        p["b"] = (t2n(ref_layer.lstm.bias_ih_l0) if has_bias
                  else np.zeros(4 * ref_layer.size, dtype=np.float32))
        return src, p
    if name == "FeedForward":
        src = ("layers.FeedForward({}, {}, has_bias={}, "
               "fun=activation.{})".format(
                   ref_layer.insize, ref_layer.size, ref_layer.has_bias,
                   ref_layer.activation.__name__))
        p = {"W": t2n(ref_layer.linear.weight)}
        if ref_layer.has_bias:
            p["b"] = t2n(ref_layer.linear.bias)
        return src, p
    if name == "GlobalNormFlipFlop":
        src = "layers.GlobalNormFlipFlop({}, {}, has_bias={})".format(
            ref_layer.insize, ref_layer.nbase, ref_layer.has_bias)
        p = {"W": t2n(ref_layer.linear.weight)}
        if ref_layer.has_bias:
            p["b"] = t2n(ref_layer.linear.bias)
        return src, p
    if name == "GlobalNormFlipFlopCatMod":
        raise NotImplementedError(
            "cat_mod import: reconstruct via AlphabetInfo then copy W/b")
    raise NotImplementedError("Layer conversion for {}".format(name))


def main(argv=None):
    args = get_parser().parse_args(argv)
    net = tolerant_torch_load(args.input, args.reference_repo)
    src_expr, params = convert_layer(net)
    model_source = (
        "from taiyaki_tpu import activation, layers\n\n\n"
        "def network(**kwargs):\n"
        "    return {}\n".format(src_expr))
    metadata = dict(getattr(net, "metadata", {}) or {})
    metadata["version"] = MODEL_VERSION
    metadata.setdefault("reverse", False)
    metadata.setdefault("standardize", True)
    ckpt = {
        "model_source": model_source,
        "model_kwargs": {},
        "params": params,
        "optimizer_state": None,
        "metadata": metadata,
    }
    with open(args.output, "wb") as fh:
        pickle.dump(ckpt, fh)
    print("Wrote", args.output)


if __name__ == "__main__":
    main()
