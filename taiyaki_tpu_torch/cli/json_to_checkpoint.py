"""Convert a Guppy JSON model back into a checkpoint (port of
misc/json_to_checkpoint.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.json_to_checkpoint [--output model.checkpoint] model.json

Layer types: convolution, LSTM, GruMod, reverse, serial,
GlobalNormTwoState and GlobalNormTwoStateCatMod.  The JSON holds every
float32 parameter exactly, so `cli.dump_json` followed by this tool gives
back the checkpoint's parameters bit for bit.  The checkpoint is the JAX
tool's: its model source imports from `taiyaki_tpu`, which the port's
loader serves with its own modules (`utils.helpers.load_model`), so both
packages load it.
"""

import argparse
import json
import pickle

import numpy as np

from taiyaki_tpu_torch import MODEL_VERSION
from taiyaki_tpu_torch.flipflopfings import nbase_flipflop
from taiyaki_tpu_torch.utils.cmdargs import FileExists
from taiyaki_tpu_torch.utils.common_cmdargs import add_common_command_args


def get_parser():
    parser = argparse.ArgumentParser(
        description="Convert JSON model to taiyaki_tpu checkpoint",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_command_args(parser, ["output"])
    parser.add_argument("json_model", action=FileExists,
                        help="JSON model with params")
    return parser


def _guppy_to_cudnn(stacked):
    """Guppy GRU gate order (z, r, n) -> CUDNN (r, z, n)."""
    z, r, n = stacked
    return np.concatenate([r, z, n], axis=0)


def convert_json_layer(jsn):
    """JSON layer dict -> (source expression, params pytree)."""
    t = jsn["type"]
    if t == "serial":
        subs = [convert_json_layer(s) for s in jsn["sublayers"]]
        return ("layers.Serial([{}])".format(", ".join(s[0] for s in subs)),
                {"sublayers": [s[1] for s in subs]})
    if t == "reverse":
        src, p = convert_json_layer(jsn["sublayers"])
        return "layers.Reverse({})".format(src), {"layer": p}
    if t == "convolution":
        p = {"W": np.array(jsn["params"]["W"], dtype=np.float32)}
        if jsn.get("bias", True):
            p["b"] = np.array(jsn["params"]["b"], dtype=np.float32)
        pad = jsn.get("padding")
        src = ("layers.Convolution({insize}, {size}, {winlen}, "
               "stride={stride}, pad={pad}, has_bias={bias}, "
               "fun=activation.{act})").format(
            insize=jsn["insize"], size=jsn["size"], winlen=jsn["winlen"],
            stride=jsn["stride"], pad=tuple(pad) if pad else None,
            bias=bool(jsn.get("bias", True)), act=jsn["activation"])
        return src, p
    if t == "LSTM":
        size, insize = jsn["size"], jsn["insize"]
        p = {"iW": np.array(jsn["params"]["iW"], np.float32).reshape(
                 4 * size, insize),
             "sW": np.array(jsn["params"]["sW"], np.float32).reshape(
                 4 * size, size),
             "b": np.array(jsn["params"]["b"], np.float32).reshape(-1)}
        return "layers.Lstm({}, {})".format(insize, size), p
    if t == "GruMod":
        size, insize = jsn["size"], jsn["insize"]
        p = {"iW": _guppy_to_cudnn(
                 np.array(jsn["params"]["iW"], np.float32)),
             "sW": _guppy_to_cudnn(
                 np.array(jsn["params"]["sW"], np.float32)),
             "b": _guppy_to_cudnn(
                 np.array(jsn["params"]["b"], np.float32)).reshape(-1)}
        return "layers.GruMod({}, {})".format(insize, size), p
    if t == "GlobalNormTwoState":
        nbase = nbase_flipflop(jsn["size"])
        p = {"W": np.array(jsn["params"]["W"], np.float32)}
        if jsn.get("bias", True):
            p["b"] = np.array(jsn["params"]["b"], np.float32)
        return ("layers.GlobalNormFlipFlop({}, {}, scale={}, "
                "has_bias={}, fun=activation.{})".format(
                    jsn["insize"], nbase, jsn.get("scale", 5.0),
                    bool(jsn.get("bias", True)),
                    jsn.get("activation", "tanh")), p)
    if t == "GlobalNormTwoStateCatMod":
        p = {"W": np.array(jsn["params"]["W"], np.float32)}
        if jsn.get("bias", True):
            p["b"] = np.array(jsn["params"]["b"], np.float32)
        # the AlphabetInfo rebuilt from the stable external attributes
        out_alphabet = jsn["output_alphabet"]
        can_nmods = list(jsn["can_nmods"])
        long_names = jsn["modified_base_long_names"]
        alphabet = out_alphabet
        collapse = []
        i = 0
        for nmod in can_nmods:
            can_b = out_alphabet[i]
            collapse.extend(can_b * (1 + nmod))
            i += 1 + nmod
        collapse = "".join(collapse)
        src = ("layers.GlobalNormFlipFlopCatMod({}, AlphabetInfo({!r}, "
               "{!r}, {!r}), has_bias={})").format(
            jsn["insize"], alphabet, collapse, list(long_names),
            bool(jsn.get("bias", True)))
        return src, p
    raise NotImplementedError("JSON layer type {} not supported".format(t))


def main(argv=None):
    args = get_parser().parse_args(argv)
    with open(args.json_model) as fh:
        jsn = json.load(fh)
    src_expr, params = convert_json_layer(jsn)
    # the JAX tool's text: the port's loader binds taiyaki_tpu's names to
    # its own modules when it runs it
    model_source = (
        "from taiyaki_tpu import activation, layers\n"
        "from taiyaki_tpu.alphabet import AlphabetInfo\n\n\n"
        "def network(**kwargs):\n"
        "    return {}\n".format(src_expr))
    ckpt = {
        "model_source": model_source,
        "model_kwargs": {},
        "params": params,
        "optimizer_state": None,
        "metadata": {"reverse": False, "standardize": True,
                     "version": MODEL_VERSION},
    }
    out = args.output or (args.json_model + ".checkpoint")
    with open(out, "wb") as fh:
        pickle.dump(ckpt, fh)
    print("Wrote", out)


if __name__ == "__main__":
    main()
