"""The port's checkpoint tools on the CPU against the JAX package's misc/
tools: json_to_checkpoint on bin/dump_json.py's JSON of the shipped remap
checkpoint and of a size-16 cat_mod checkpoint (the same model source and
parameters, bit for bit, and the round trip exact), upgrade_model from
version 2 and its refusal of torch pickles, and import_torch_checkpoint on
a torch checkpoint of a stand-in reference `taiyaki` package written
here."""

import importlib.util
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_cli import one_torch_thread, subprocess_env, write_reads  # noqa: F401
from test_torch_msf_tools import run_jax, run_port
from taiyaki_tpu_torch.cli import (
    import_torch_checkpoint as timport, json_to_checkpoint as tjson,
    upgrade_model as tupgrade)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAP = os.path.join(REPO, "taiyaki_tpu", "models",
                     "mGru_flipflop_remapping_model_r9_DNA.checkpoint")


def load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def leaves(tree, prefix=""):
    """{path: leaf} of a parameter pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, "{}/{}".format(prefix, k)))
    return out


def assert_params_bitwise(got, want):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _catmod_checkpoint(d):
    from test_torch_dump_json import _catmod_checkpoint as make
    return make(d)


@pytest.mark.parametrize("which", ["remap", "catmod"])
def test_json_to_checkpoint_matches_jax(which, tmp_path, monkeypatch,
                                        capsys):
    src = REMAP if which == "remap" else _catmod_checkpoint(tmp_path)
    js = str(tmp_path / "model.json")
    spec = importlib.util.spec_from_file_location(
        "jax_bin_dump_json", os.path.join(REPO, "bin", "dump_json.py"))
    dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dump)
    monkeypatch.setattr(sys, "argv", ["dump_json.py", "--output", js, src])
    dump.main()
    outs = []
    for who in ("jax", "port"):
        out = str(tmp_path / (who + ".checkpoint"))
        argv = ["--output", out, js]
        if who == "jax":
            res = run_jax("json_to_checkpoint", argv, monkeypatch, capsys)
        else:
            res = run_port(tjson.main, argv, capsys)
        assert res[0] == 0 and "Wrote" in res[1]
        outs.append(load(out))
    jax, port = outs
    assert port["model_source"] == jax["model_source"]
    assert "from taiyaki_tpu import activation, layers" in \
        port["model_source"]
    assert port["metadata"] == jax["metadata"]
    assert port["model_kwargs"] == jax["model_kwargs"] == {}
    assert_params_bitwise(port["params"], jax["params"])
    if which == "remap":
        # the JSON holds each float32 exactly: the round trip is exact
        assert_params_bitwise(port["params"], load(src)["params"])


def test_round_trip_checkpoint_calls_as_the_original(tmp_path):
    """dump_json then json_to_checkpoint of the shipped remap checkpoint,
    through the port's tools only: it loads in the port and calls a
    synthetic read as the original does (--device cpu)."""
    from taiyaki_tpu_torch.cli import basecall, dump_json
    js = str(tmp_path / "remap.json")
    dump_json.main(["--output", js, REMAP])
    ckpt = str(tmp_path / "rt.checkpoint")
    tjson.main(["--output", ckpt, js])
    reads = tmp_path / "reads"
    reads.mkdir()
    write_reads(str(reads / "r.fast5"), [6000], seed=4)
    calls = []
    for model in (REMAP, ckpt):
        out = str(tmp_path / "{}.fa".format(len(calls)))
        basecall.main(["--device", "cpu", "--output", out, "--quiet",
                       str(reads), model])
        with open(out) as fh:
            calls.append(fh.read())
    assert calls[0].count(">") == 1 and len(calls[0]) > 100
    assert calls[1] == calls[0]


def _old_checkpoint(tmp_path):
    """tests/test_misc_cli.py's version-2 checkpoint: the shipped one with
    no standardize and version 2."""
    ckpt = load(REMAP)
    ckpt["metadata"].pop("standardize", None)
    ckpt["metadata"]["version"] = 2
    old = str(tmp_path / "old.checkpoint")
    with open(old, "wb") as fh:
        pickle.dump(ckpt, fh)
    return old


def test_upgrade_model_matches_jax(tmp_path, monkeypatch, capsys):
    old = _old_checkpoint(tmp_path)
    outs = []
    for who in ("jax", "port"):
        out = str(tmp_path / (who + ".checkpoint"))
        if who == "jax":
            res = run_jax("upgrade_model", [old, out], monkeypatch, capsys)
        else:
            res = run_port(tupgrade.main, [old, out], capsys)
        assert res[0] == 0
        assert "Upgrading model from version 2 to 3" in res[1]
        outs.append(load(out))
    jax, port = outs
    assert port["metadata"] == jax["metadata"]
    assert port["metadata"]["version"] == 3
    assert port["metadata"]["standardize"] is True
    assert port["model_source"] == jax["model_source"]
    assert_params_bitwise(port["params"], jax["params"])
    # at version 3 it is copied unchanged
    res = run_port(tupgrade.main, [str(tmp_path / "port.checkpoint"),
                                   str(tmp_path / "again.checkpoint")],
                   capsys)
    assert "Model already at version 3" in res[1]
    assert load(str(tmp_path / "again.checkpoint"))["metadata"] == \
        port["metadata"]


def test_upgrade_model_sends_torch_pickles_to_the_importer(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    import torch
    path = str(tmp_path / "torch.checkpoint")
    torch.save(torch.nn.Linear(3, 2), path)
    for who in ("jax", "port"):
        out = str(tmp_path / (who + ".checkpoint"))
        if who == "jax":
            res = run_jax("upgrade_model", [path, out], monkeypatch, capsys)
        else:
            res = run_port(tupgrade.main, [path, out], capsys)
        assert res[0] != 0 and "import_torch_checkpoint" in str(res[0])
        assert not os.path.exists(out)


# a stand-in for the reference taiyaki package: the module classes and
# the attributes that convert_layer reads, nothing that runs
STANDIN_LAYERS = '''
import torch.nn as nn

from taiyaki import activation


class Serial(nn.Module):
    def __init__(self, sublayers):
        super().__init__()
        self.sublayers = nn.ModuleList(sublayers)


class Reverse(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer


class Convolution(nn.Module):
    def __init__(self, insize, size, winlen, stride=1, has_bias=True,
                 fun=activation.tanh):
        super().__init__()
        self.insize, self.size, self.winlen = insize, size, winlen
        self.stride, self.has_bias, self.activation = stride, has_bias, fun
        self.conv = nn.Conv1d(insize, size, winlen, stride=stride,
                              bias=has_bias)


class GruMod(nn.Module):
    def __init__(self, insize, size, has_bias=True):
        super().__init__()
        self.insize, self.size, self.has_bias = insize, size, has_bias
        self.cudnn_gru = nn.GRU(insize, size, bias=has_bias)


class GlobalNormFlipFlop(nn.Module):
    def __init__(self, insize, nbase, has_bias=True):
        super().__init__()
        self.insize, self.nbase, self.has_bias = insize, nbase, has_bias
        self.linear = nn.Linear(insize, 2 * nbase * (nbase + 1),
                                bias=has_bias)
'''

STANDIN_MODEL = '''
import sys
sys.path.insert(0, sys.argv[1])
import torch
from taiyaki import activation, layers
torch.manual_seed(0)
net = layers.Serial([
    layers.Convolution(1, 8, 5, stride=2, fun=activation.tanh),
    layers.Reverse(layers.GruMod(8, 8)),
    layers.GruMod(8, 8, has_bias=False),
    layers.Reverse(layers.GruMod(8, 8)),
    layers.GlobalNormFlipFlop(8, 4)])
net.metadata = {"reverse": False, "standardize": True}
torch.save(net, sys.argv[2])
'''


@pytest.fixture
def reference_checkpoint(tmp_path):
    pkg = tmp_path / "ref" / "taiyaki"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "activation.py").write_text(
        "import torch\n\n\ndef tanh(x):\n    return torch.tanh(x)\n")
    (pkg / "layers.py").write_text(textwrap.dedent(STANDIN_LAYERS))
    ckpt = str(tmp_path / "reference.checkpoint")
    r = subprocess.run([sys.executable, "-c", STANDIN_MODEL,
                        str(tmp_path / "ref"), ckpt], env=subprocess_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(tmp_path / "ref"), ckpt


def test_import_torch_checkpoint_matches_jax(reference_checkpoint, tmp_path,
                                             capsys):
    """The JAX tool (a subprocess: it patches torch's RNN unpickling for
    good) and the port's (in process; its patch and path entry are undone
    after the load) on one checkpoint of the stand-in package: the same
    model source and parameters, and the result builds in the port."""
    repo, ckpt = reference_checkpoint
    jax_out = str(tmp_path / "jax.checkpoint")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "misc", "import_torch_checkpoint.py"), ckpt, jax_out,
        "--reference_repo", repo], cwd=REPO, env=subprocess_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]

    from torch.nn.modules import rnn as rnn_mod
    setstate, path = rnn_mod.RNNBase.__setstate__, list(sys.path)
    port_out = str(tmp_path / "port.checkpoint")
    try:
        res = run_port(timport.main, [ckpt, port_out, "--reference_repo",
                                      repo], capsys)
    finally:
        for name in [m for m in sys.modules
                     if m == "taiyaki" or m.startswith("taiyaki.")]:
            del sys.modules[name]
    assert res[0] == 0 and "Wrote" in res[1]
    assert rnn_mod.RNNBase.__setstate__ is setstate and sys.path == path
    jax, port = load(jax_out), load(port_out)
    assert port["model_source"] == jax["model_source"]
    assert "layers.GruMod(8, 8, has_bias=False)" in port["model_source"]
    assert port["metadata"] == jax["metadata"]
    assert port["metadata"]["version"] == 3
    assert_params_bitwise(port["params"], jax["params"])
    assert not leaves(port["params"])["/sublayers/2/b"].any()

    import torch
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    net, params, *_ = helpers.load_model(port_out)
    net = load_jax_params(net, params)
    with torch.no_grad():
        y = net(torch.zeros(40, 2, 1))
    assert y.shape == (20, 2, 40) and torch.isfinite(y).all()
