"""The port's squiggle CLIs and train_abinitio on the CPU against the JAX
package's (bin/): train_squiggle (the final parameters), predict_squiggle
of each package on the other's checkpoint (the TSVs), map_to_squiggle on
the repo's three real reads written as fast5 (scores and paths), and
train_abinitio on a chunks file h5py writes (the final parameters; the
references' .pkl cache written, and loaded by a second run).

Each pair of CLI runs happens once a pytest run (`shared_run`).
Tolerances: parameters 1e-4 (f32 convolutions and AdamW in another
order; eps 1e-6 amplifies a gradient's last bits); predicted squiggles
1e-5; map scores 1e-4 relative; paths equal, or within the near-tie rule
of the data-preparation tests (under 1% of samples moved, none by more
than 32 positions)."""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from test_torch_cli import shared_run, subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INGREDIENTS = os.path.join(REPO, "RESULTS", "training_ingredients")
READS = os.path.join(INGREDIENTS, "mapped_remap_samref.hdf5")
REFS = os.path.join(INGREDIENTS, "per_read_references_from_sam.fa")
SQUIGGLE_ARGS = ["--size", "8", "--depth", "2", "--winlen", "5",
                 "--target_len", "100", "--batch_size", "6",
                 "--niteration", "2", "--save_every", "2", "--seed", "4",
                 "--sample_nreads_before_filtering", "20"]
ABINITIO_ARGS = ["--size", "16", "--stride", "2", "--winlen", "9",
                 "--niteration", "2", "--batch_size", "4", "--save_every",
                 "2", "--seed", "2"]
FASTA = ">seq1\nACGTACGTGGCATTACGGA\n>seq2\nTTTTGCAGCCATAG\n"


def _run(cli, args, port, stdout=False):
    """One CLI: bin/<cli>.py, or the port's module on the CPU."""
    cmd = ([sys.executable, "-m", "taiyaki_tpu_torch.cli." + cli,
            "--device", "cpu"] if port
           else [sys.executable, os.path.join(REPO, "bin", cli + ".py")])
    r = subprocess.run(cmd + list(args), cwd=REPO,
                       env=subprocess_env(one_jax_device=True),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout if stdout else r


def _params(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _params_match(got, want, tol=1e-4):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def write_real_reads(path):
    """The repo's three real mapped reads as one multi-read fast5 (h5py)."""
    import h5py
    with h5py.File(READS, "r") as f, h5py.File(path, "w") as out:
        for rid in f["Reads"]:
            g = f["Reads"][rid]
            grp = out.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k in ("digitisation", "offset", "range"):
                ch.attrs[k] = g.attrs[k]
            ch.attrs["sampling_rate"] = 4000.0
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = len(g["Dacs"])
            raw.create_dataset("Signal", data=g["Dacs"][()].astype("i2"))


def _squiggle_runs(d):
    """Both trainers, then each predictor on both checkpoints, then both
    mappers on the JAX checkpoint."""
    out = {}
    for tag, port in (("jax", False), ("port", True)):
        outdir = str(d / tag)
        _run("train_squiggle", SQUIGGLE_ARGS + ["--outdir", outdir, READS],
             port)
        out[tag] = os.path.join(outdir, "model_final")
    fasta = d / "in.fa"
    fasta.write_text(FASTA)
    for ckpt in ("jax", "port"):
        for tag, port in (("jax", False), ("port", True)):
            out["predict", ckpt, tag] = _run(
                "predict_squiggle", [out[ckpt] + ".checkpoint", str(fasta)],
                port, stdout=True)
    reads = d / "reads"
    reads.mkdir()
    write_real_reads(str(reads / "real.fast5"))
    for tag, port in (("jax", False), ("port", True)):
        out["map", tag] = _run(
            "map_to_squiggle", [out["jax"] + ".checkpoint", REFS,
                                str(reads)], port, stdout=True)
    return out


@pytest.fixture(scope="module")
def squiggle(tmp_path_factory):
    return shared_run(tmp_path_factory, "squiggle_cli", _squiggle_runs)


def test_train_squiggle_matches_jax(squiggle):
    _params_match(_params(squiggle["port"] + ".params"),
                  _params(squiggle["jax"] + ".params"))
    with open(squiggle["port"] + ".checkpoint", "rb") as fh:
        ckpt = pickle.load(fh)
    with open(squiggle["jax"] + ".checkpoint", "rb") as fh:
        jckpt = pickle.load(fh)
    assert ckpt["model_source"] == jckpt["model_source"]
    assert ckpt["metadata"] == jckpt["metadata"]


def _tsv(text):
    rows = [line.split("\t") for line in text.splitlines()]
    header = [r for r in rows if r[0] == "base"]
    body = [r for r in rows if r[0] != "base"]
    return header, [r[0] for r in body], np.array(
        [[float(v) for v in r[1:]] for r in body])


@pytest.mark.parametrize("ckpt", ["jax", "port"])
def test_predict_squiggle_matches_jax(squiggle, ckpt):
    """Each package's predictor on the checkpoint of either trainer."""
    got, want = (_tsv(squiggle["predict", ckpt, tag])
                 for tag in ("port", "jax"))
    assert got[0] == want[0] and len(got[0]) == 2
    assert got[1] == want[1] == list("ACGTACGTGGCATTACGGATTTTGCAGCCATAG")
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


def _mapping(text):
    """{read id: (score, positions, rows [sample, current, pos, level, log
    scale, rate])} of map_to_squiggle's output."""
    out, rid = {}, None
    for line in text.splitlines():
        if line.startswith("#"):
            rid, score = line[1:].split(" ")
            out[rid] = (float(score), [])
        else:
            f = line.split("\t")
            assert f[0] == rid
            out[rid][1].append([float(f[i]) for i in (1, 2, 3, 5, 6, 7)]
                               + [f[4]])
    return out


def test_map_to_squiggle_matches_jax(squiggle):
    got, want = (_mapping(squiggle["map", tag]) for tag in ("port", "jax"))
    assert sorted(got) == sorted(want) and len(got) == 3
    for rid in want:
        (score, rows), (jscore, jrows) = got[rid], want[rid]
        np.testing.assert_allclose(score, jscore, rtol=1e-4)
        assert len(rows) == len(jrows)
        num = np.array([r[:6] for r in rows])
        jnum = np.array([r[:6] for r in jrows])
        np.testing.assert_array_equal(num[:, :2], jnum[:, :2])
        moved = num[:, 2] != jnum[:, 2]
        assert moved.mean() < 0.01
        assert np.abs(num[:, 2] - jnum[:, 2]).max() <= 32
        same = ~moved
        assert [r[6] for r, s in zip(rows, same) if s] == \
            [r[6] for r, s in zip(jrows, same) if s]
        np.testing.assert_allclose(num[same, 3:], jnum[same, 3:], rtol=1e-5,
                                   atol=1e-5)


def _abinitio_runs(d):
    """The chunks file (h5py) and its fasta; the port's trainer on the
    fasta (writes refs.pkl), the JAX trainer on the .pkl and the port's
    again on it."""
    import h5py
    rng = np.random.default_rng(0)
    nchunk, chunk_len = 20, 400
    chunks = str(d / "chunks.hdf5")
    with h5py.File(chunks, "w") as f:
        f.create_dataset("chunks", data=rng.normal(
            size=(nchunk, chunk_len)).astype(np.float32))
    with open(str(d / "refs.fa"), "w") as fh:
        for i in range(nchunk):
            fh.write(">{}\n{}\n".format(
                i, "".join(rng.choice(list("ACGT"), size=40))))
    out = {}
    for tag, port, ref in (("port", True, "refs.fa"),
                           ("jax", False, "refs.pkl"),
                           ("port_pkl", True, "refs.pkl")):
        outdir = str(d / tag)
        model = os.path.join(REPO, "taiyaki_tpu_torch" if port
                             else "taiyaki_tpu", "models", "mGru_flipflop.py")
        _run("train_abinitio", ABINITIO_ARGS + [
            "--outdir", outdir, model, chunks, str(d / ref)], port)
        out[tag] = outdir
    return out


@pytest.fixture(scope="module")
def abinitio(tmp_path_factory):
    return shared_run(tmp_path_factory, "abinitio_cli", _abinitio_runs)


def test_train_abinitio_matches_jax(abinitio):
    port = _params(os.path.join(abinitio["port"], "model_final.params"))
    _params_match(port, _params(os.path.join(abinitio["jax"],
                                             "model_final.params")))
    for name in ("model_checkpoint_00000.checkpoint",
                 "model_checkpoint_00001.checkpoint",
                 "model_final.checkpoint", "model.py", "model.log"):
        assert os.path.exists(os.path.join(abinitio["port"], name))


def test_train_abinitio_caches_references(abinitio):
    """The first run writes refs.pkl; the JAX CLI and a second port run
    load it and train to the same parameters."""
    base = os.path.dirname(abinitio["port"])
    with open(os.path.join(base, "refs.pkl"), "rb") as fh:
        refs = pickle.load(fh)
    assert sorted(refs) == list(range(20))
    assert all(len(v) == 40 for v in refs.values())
    for tag in ("jax", "port_pkl"):
        with open(os.path.join(abinitio[tag], "model.log")) as fh:
            assert "* Loaded preprocessed references" in fh.read()
    _params_match(
        _params(os.path.join(abinitio["port_pkl"], "model_final.params")),
        _params(os.path.join(abinitio["port"], "model_final.params")),
        tol=0)


MODEL_PY = os.path.join(REPO, "taiyaki_tpu_torch", "models",
                        "mGru_flipflop.py")
NO_DEVICE_ARGV = {
    "train_squiggle": [READS],
    "predict_squiggle": [MODEL_PY, REFS],
    "map_to_squiggle": [MODEL_PY, REFS, INGREDIENTS],
    "train_abinitio": [MODEL_PY, READS, REFS]}


@pytest.mark.parametrize("cli", sorted(NO_DEVICE_ARGV))
def test_cli_default_device_is_cuda(cli):
    """With no --device each CLI asks for the card; without one it exits
    naming CUDA, before it reads or writes anything."""
    import importlib
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = importlib.import_module("taiyaki_tpu_torch.cli." + cli)
    with pytest.raises(SystemExit, match="CUDA"):
        module.main(NO_DEVICE_ARGV[cli])
