"""`python -m taiyaki_tpu_torch.cli.dump_json` against bin/dump_json.py on
the CPU: byte-equal files for the shipped mGru remap checkpoint and a
size-16 mLstm cat_mod checkpoint written by the JAX package, and the
same file for a checkpoint the port wrote."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import shared_run, subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAP = os.path.join(REPO, "taiyaki_tpu", "models",
                     "mGru_flipflop_remapping_model_r9_DNA.checkpoint")


def _catmod_checkpoint(d):
    from taiyaki_tpu import alphabet as jalphabet
    from taiyaki_tpu.models import mLstm_cat_mod_flipflop as jmodel
    from taiyaki_tpu.utils import helpers as jhelpers
    ai = jalphabet.AlphabetInfo("AYCZGT", "AACCGT", ["6mA", "5mC"])
    kwargs = dict(insize=1, size=16, winlen=19, stride=5, alphabet_info=ai)
    net = jmodel.network(**kwargs)
    with open(jmodel.__file__) as fh:
        source = fh.read()
    return jhelpers.save_model(str(d), net,
                               net.init(np.random.default_rng(8)), source,
                               kwargs, {"reverse": False,
                                        "standardize": True, "version": 3})


def _dump_both(d):
    """Each checkpoint dumped by both CLIs: {name: (jax bytes, port
    bytes)}."""
    out = {}
    for name, model in (("remap", REMAP),
                        ("catmod", _catmod_checkpoint(d))):
        got = []
        for cmd in ([os.path.join(REPO, "bin", "dump_json.py")],
                    ["-m", "taiyaki_tpu_torch.cli.dump_json"]):
            path = str(d / "{}_{}.json".format(name, len(got)))
            r = subprocess.run([sys.executable] + cmd
                               + ["--output", path, model], cwd=REPO,
                               env=subprocess_env(), capture_output=True,
                               text=True, timeout=300)
            assert r.returncode == 0, r.stderr[-3000:]
            with open(path, "rb") as fh:
                got.append(fh.read())
        out[name] = tuple(got)
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    return shared_run(tmp_path_factory, "dump_json", _dump_both)


@pytest.mark.parametrize("name", ["remap", "catmod"])
def test_dump_json_matches_jax_byte_for_byte(dumps, name):
    jax_bytes, port_bytes = dumps[name]
    assert len(port_bytes) > 10000
    assert port_bytes == jax_bytes


def test_dump_json_of_a_port_checkpoint(tmp_path):
    """A checkpoint written by the port (`helpers.save_model`) exports as
    the JAX CLI exports it, GRU gates reordered as Guppy wants them."""
    import json
    from taiyaki_tpu_torch.cli import dump_json
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.utils import helpers
    net, params, source, meta, kwargs, _ = helpers.load_model(REMAP)
    net = load_jax_params(net, params)
    ckpt = helpers.save_model(str(tmp_path), net, params_to_jax(net), source,
                              kwargs, meta)
    out = [str(tmp_path / "port.json"), str(tmp_path / "jax.json")]
    dump_json.main(["--output", out[0], ckpt])
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "bin", "dump_json.py"),
                        "--output", out[1], ckpt], cwd=REPO,
                       env=subprocess_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out[0]) as a, open(out[1]) as b:
        text = a.read()
        assert text == b.read()
    gru = json.loads(text)["sublayers"][2]
    assert gru["type"] == "GruMod"
    H = gru["size"]
    sW = net.sublayers[2].sW.detach().numpy()
    np.testing.assert_array_equal(np.asarray(gru["params"]["sW"][0],
                                             np.float32), sW[H:2 * H])
    np.testing.assert_array_equal(np.asarray(gru["params"]["sW"][1],
                                             np.float32), sW[:H])
