"""The cat_mod family of the port on the CPU against the JAX package: the
cat_mod loss (value, gradient, the zero-weight and sharpening
conventions), the GlobalNormFlipFlopCatMod head and both cat_mod models
with parameters carried by convert.params_from_jax, batches with mod
labels, one training step, the training CLI against bin/train_flipflop.py
on the repo's modref reads and, with --mod_prior_factor, on synthetic mod
reads, and --modified_base_output against bin/basecall.py.  Same seeded
numpy inputs.

Tolerances: loss and gradients 1e-5 (f32, the same DP in another order);
network outputs 1e-5; one training step: loss 1e-5 relative, each
gradient 1e-4 of its tensor's largest value (as tests/test_torch_train.py
states); the CLI's batch.log: 1e-5 relative at the first iteration, 1e-4
after (the Adam bound of tests/test_torch_train.py); the logged prior
weights to their printed four decimals; mod scores 1e-4 (log-softmax
outputs through 5 recurrent layers)."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import alphabet as jalphabet
from taiyaki_tpu import flipflopfings as jfff
from taiyaki_tpu import layers as jlayers
from taiyaki_tpu import train as jtrain
from taiyaki_tpu.data import chunk_selection as jcs
from taiyaki_tpu.data import mapped_signal_files as jmsf
from taiyaki_tpu.models import mGru_cat_mod_flipflop as jgru
from taiyaki_tpu.models import mLstm_cat_mod_flipflop as jlstm
from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu_torch import alphabet as talphabet
from taiyaki_tpu_torch import layers as tlayers
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
from taiyaki_tpu_torch.data import mapped_signal_files as tmsf
from taiyaki_tpu_torch.models import mGru_cat_mod_flipflop as tgru
from taiyaki_tpu_torch.models import mLstm_cat_mod_flipflop as tlstm
from taiyaki_tpu_torch.ops import flipflop as tff
# one_torch_thread is an autouse fixture
from test_torch_cli import (  # noqa: F401
    one_torch_thread, subprocess_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODREF = os.path.join(REPO, "RESULTS", "training_ingredients",
                      "mapped_remap_modref.hdf5")
NTRANS = 40
MODELS = {"mLstm": (jlstm, tlstm, 5), "mGru": (jgru, tgru, 2)}
ALPHABET = ("AYCZGT", "AACCGT", ["6mA", "5mC"])


def _env():
    return subprocess_env(one_jax_device=True)


def _alphabets(spec=ALPHABET):
    return jalphabet.AlphabetInfo(*spec), talphabet.AlphabetInfo(*spec)


# -- the loss ----------------------------------------------------------------

def _loss_case(seed, nmods=(1, 0, 2, 0), T=9, B=4, L=7):
    """Cat_mod layer outputs, ragged sequences (row 1 empty), mod
    categories and weights."""
    rng = np.random.default_rng(seed)
    nmods = np.array(nmods)
    offsets = np.cumsum(np.concatenate([[0], nmods + 1])).astype(np.int32)
    x = rng.normal(size=(T, B, NTRANS + int(offsets[-1]))).astype(
        np.float32)
    seqlens = rng.integers(2, L + 1, size=B).astype(np.int32)
    seqlens[1] = 0
    seqs = np.zeros((B, L), np.int32)
    mod_cats = np.zeros((B, L), np.int32)
    for b in range(B):
        bases = rng.integers(0, 4, size=seqlens[b])
        seqs[b, :seqlens[b]] = jfff.flipflop_code(bases)
        for i, base in enumerate(bases):
            if nmods[base] and rng.random() < 0.5:
                mod_cats[b, i] = rng.integers(1, nmods[base] + 1)
    weights = rng.uniform(0.5, 2.0, size=int(offsets[-1])).astype(
        np.float32)
    return x, seqs, seqlens, mod_cats, offsets, weights


def _port_loss(x, seqs, seqlens, mod_cats, offsets, weights, sharpfact,
               g=None):
    tx = torch.from_numpy(x).requires_grad_()
    out = tff.cat_mod_flipflop_loss(
        tx, torch.from_numpy(seqs), torch.from_numpy(seqlens),
        torch.from_numpy(mod_cats), offsets, weights, sharpfact)
    out.backward(torch.ones_like(out) if g is None else torch.from_numpy(g))
    return out.detach().numpy(), tx.grad.numpy()


@pytest.mark.parametrize("sharpfact", [1.0, 2.0])
def test_cat_mod_loss_matches_jax(sharpfact):
    x, seqs, seqlens, mod_cats, offsets, weights = _loss_case(seed=1)
    g = np.random.default_rng(2).normal(size=len(seqlens)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jff.cat_mod_flipflop_loss(
        v, jnp.asarray(seqs), jnp.asarray(seqlens), jnp.asarray(mod_cats),
        offsets, weights, sharpfact), jnp.asarray(x))
    got, grad = _port_loss(x, seqs, seqlens, mod_cats, offsets, weights,
                           sharpfact, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)
    assert got[1] == 0.0 and not grad[:, 1].any()


def test_cat_mod_zero_weight_reduces_to_canonical():
    x, seqs, seqlens, mod_cats, offsets, weights = _loss_case(seed=3)
    got, grad = _port_loss(x, seqs, seqlens, mod_cats, offsets,
                           np.zeros_like(weights), 1.0)
    tx = torch.from_numpy(x[:, :, :NTRANS]).requires_grad_()
    can = tff.crf_flipflop_loss(tx, torch.from_numpy(seqs),
                                torch.from_numpy(seqlens))
    can.sum().backward()
    np.testing.assert_allclose(got, can.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(grad[:, :, :NTRANS], tx.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not grad[:, :, NTRANS:].any()


def test_cat_mod_sharpened_gradient_convention():
    """The gradient is the core DP's at the sharpened scores for every
    column (no sharpening chain factor, no 1/sharpfact): plain autodiff
    would divide the mod columns' by sharpfact."""
    x, seqs, seqlens, mod_cats, offsets, weights = _loss_case(seed=4)
    sharpfact = 2.0
    _, grad = _port_loss(x, seqs, seqlens, mod_cats, offsets, weights,
                         sharpfact)
    sharp = np.where(np.arange(x.shape[2]) < NTRANS, sharpfact, 1.0)
    _, core = _port_loss((x * sharp).astype(np.float32), seqs, seqlens,
                         mod_cats, offsets, weights, 1.0)
    np.testing.assert_allclose(grad, core, rtol=1e-5, atol=1e-6)
    assert not np.allclose(grad[:, :, NTRANS:], core[:, :, NTRANS:] /
                           sharpfact)


# -- the head and the models -------------------------------------------------

ATTRS = ("can_nmods", "output_alphabet", "ordered_mod_long_names",
         "can_mods_offsets", "can_labels", "mod_labels", "ntrans_states",
         "size", "out_size", "nbase", "ncan_base", "nmod_base")


def _same_attrs(t, j):
    for name in ATTRS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)


@pytest.mark.parametrize("spec", [ALPHABET, ("ACGTZ", "ACGTA", ["5mZ"]),
                                  ("ACGT", "ACGT", None)])
def test_head_matches_jax(spec):
    jai, tai = _alphabets(spec)
    jhead = jlayers.GlobalNormFlipFlopCatMod(12, jai)
    thead = tlayers.GlobalNormFlipFlopCatMod(12, tai)
    params = jhead.init(np.random.default_rng(5))
    load_jax_params(thead, params)
    _same_attrs(thead, jhead)
    x = np.random.default_rng(6).normal(size=(7, 3, 12)).astype(np.float32)
    want = np.asarray(jhead.apply(params, jnp.asarray(x)))
    got = thead(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (7, 3, jhead.out_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cat_mod_models_match_jax(name):
    jmod, tmod, stride = MODELS[name]
    jai, tai = _alphabets()
    jnet = jmod.network(size=16, stride=stride, alphabet_info=jai)
    tnet = tmod.network(size=16, stride=stride, alphabet_info=tai)
    params = jnet.init(np.random.default_rng(7))
    load_jax_params(tnet, params)
    assert tlayers.is_cat_mod_model(tnet) and jlayers.is_cat_mod_model(jnet)
    assert tnet.stride == stride
    _same_attrs(tnet.sublayers[-1], jnet.sublayers[-1])
    x = np.random.default_rng(8).normal(size=(200, 2, 1)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (200 // stride, 2, 46)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- batches and one training step -------------------------------------------

def _modref_batch(sample_batch, cs, msf, seed, n=6, chunk_len=500):
    with msf.MappedSignalReader(MODREF) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    head = jlstm.network(size=8, alphabet_info=jalphabet.AlphabetInfo(
        alphabet.alphabet, alphabet.collapse_alphabet,
        alphabet.mod_long_names)).sublayers[-1]
    np.random.seed(seed)
    fp = cs.sample_filter_parameters(reads, 50, chunk_len, 3.0, 10.0, 0.5, 5,
                                     1.1)
    batch, _ = sample_batch(reads, chunk_len, n,
                            jtrain.max_seqlen_for_chunk(chunk_len, 5),
                            alphabet, fp, can_labels=head.can_labels,
                            mod_labels=head.mod_labels,
                            seqlen_granularity=128)
    return batch


def test_batches_with_mod_labels_match_jax():
    """One numpy seed draws the same chunks, canonical codes and mod
    categories from the modref reads in both packages; the modref data
    has mod positions."""
    want = _modref_batch(jtrain.sample_batch, jcs, jmsf, seed=3)
    from taiyaki_tpu_torch.data import chunk_selection as tcs
    got = _modref_batch(ttrain.sample_batch, tcs, tmsf, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got.mod_cats.shape == got.seqs.shape and got.mod_cats.any()
    tb = ttrain.batch_to_device(got, torch.device("cpu"))
    assert torch.equal(tb.mod_cats, torch.from_numpy(got.mod_cats))


def test_train_step_matches_jax():
    """Loss and every gradient of one cat_mod training step, sharpened
    and at the --mod_factor ramp's start (x8), then the step's grad_maxs."""
    batch = _modref_batch(jtrain.sample_batch, jcs, jmsf, seed=4)
    batch.seqlens[-1] = 0                   # one padding row
    jai, tai = _alphabets()
    jnet = jlstm.network(size=16, alphabet_info=jai)
    params = jnet.init(np.random.default_rng(9))
    tnet = load_jax_params(tlstm.network(size=16, alphabet_info=tai),
                           params)
    head = jnet.sublayers[-1]
    weights = np.random.default_rng(1).uniform(
        0.5, 2.0, size=head.ncan_base + head.nmod_base).astype(np.float32)
    cat_mod = (True, head.can_mods_offsets, weights)
    jbatch = jtrain.Batch(*(jnp.asarray(a) for a in batch))
    jloss, jgrads = jax.value_and_grad(jtrain.make_loss_fn(jnet, *cat_mod))(
        params, jbatch, 1.5, 8.0)
    tbatch = ttrain.batch_to_device(batch, torch.device("cpu"))
    tloss, tgrads = ttrain.make_grad_step(tnet, *cat_mod)(tbatch, 1.5, 8.0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name, g, w in zip(leaf_names(tnet), tgrads,
                          jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
    opt, _ = ttrain.make_optimizer(ttrain.leaf_params(tnet), 4e-3, 10, 2,
                                   1e-4, 1e-4)
    step = ttrain.make_train_step(tnet, opt, *cat_mod)
    loss2, maxs = step(tbatch, 1.5, np.full(len(tgrads), np.inf), 8.0)
    assert float(loss2) == pytest.approx(float(tloss), rel=1e-6)
    np.testing.assert_allclose(maxs.numpy(), [g.abs().max() for g in tgrads],
                               rtol=1e-6)


# -- the training CLI --------------------------------------------------------

CLI_ARGS = ["--device", "cpu", "--size", "16", "--stride", "2", "--winlen",
            "9", "--niteration", "3", "--warmup_batches", "1",
            "--chunk_len_min", "300", "--chunk_len_max", "400",
            "--min_sub_batch_size", "4", "--save_every", "2",
            "--sample_nreads_before_filtering", "50",
            "--reporting_sub_batches", "10", "--seed", "5", "--quiet"]


def _train_both(d, model, reads, extra=()):
    """bin/train_flipflop.py and the port's CLI, same arguments and seed,
    the model file `model` of each package."""
    out = {}
    for tag, cmd, pkg in (
            ("jax", [os.path.join(REPO, "bin", "train_flipflop.py")],
             "taiyaki_tpu"),
            ("port", ["-m", "taiyaki_tpu_torch.cli.train_flipflop"],
             "taiyaki_tpu_torch")):
        outdir = str(d / tag)
        r = subprocess.run([sys.executable] + cmd + CLI_ARGS + list(extra)
                           + ["--outdir", outdir,
                              os.path.join(REPO, pkg, "models", model),
                              reads], cwd=REPO, env=_env(),
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        out[tag] = outdir
    return out


def _log(outdir, name):
    with open(os.path.join(outdir, name)) as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def _batch_logs_match(trained):
    jrows, trows = (_log(trained[k], "batch.log") for k in ("jax", "port"))
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 4
    for i, (t, j) in enumerate(zip(trows[1:], jrows[1:])):
        assert (t[0], t[3], t[5]) == (j[0], j[3], j[5])
        rtol = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(float(t[1]), float(j[1]), rtol=rtol)
        np.testing.assert_allclose(
            [float(v) for v in t[2].split(",")],
            [float(v) for v in j[2].split(",")], rtol=10 * rtol)


def test_cli_batch_log_matches_jax_on_modref(tmp_path):
    """mLstm_cat_mod_flipflop at size 16 for 3 iterations on the modref
    reads: batch.log (the mod factor at its x8 start), validation.log, and
    the port's checkpoint loading in the JAX package with the alphabet."""
    trained = _train_both(tmp_path, "mLstm_cat_mod_flipflop.py", MODREF)
    _batch_logs_match(trained)
    jval, tval = (_log(trained[k], "validation.log") for k in ("jax",
                                                              "port"))
    assert [r[0] for r in tval] == [r[0] for r in jval] == ["iter", "2"]
    np.testing.assert_allclose(float(tval[1][1]), float(jval[1][1]),
                               rtol=1e-4)
    from taiyaki_tpu.utils import helpers as jhelpers
    net, _, _, _, kwargs, _ = jhelpers.load_model(
        os.path.join(trained["port"], "model_final.checkpoint"))
    assert jlayers.is_cat_mod_model(net)
    assert kwargs["alphabet_info"].alphabet == ALPHABET[0]


def test_mod_prior_factor_raises_on_modref(tmp_path):
    """The modref reads never hold label Y, so the log-odds priors are
    refused in both packages."""
    with jmsf.MappedSignalReader(MODREF) as msr:
        ai, reads = msr.get_alphabet_information(), list(msr.reads())
    with pytest.raises(NotImplementedError, match="must occur"):
        ai.compute_log_odds_weights(reads, 10)
    from taiyaki_tpu_torch.cli import train_flipflop
    with pytest.raises(NotImplementedError, match="must occur"):
        train_flipflop.main(["--device", "cpu", "--mod_prior_factor", "0.5",
                             "--size", "16", "--outdir", str(tmp_path / "o"),
                             os.path.join(REPO, "taiyaki_tpu_torch",
                                          "models",
                                          "mLstm_cat_mod_flipflop.py"),
                             MODREF])


def _synth_mod_file(path):
    """tests/test_pallas_mesh_catmod.py's synthetic reads (alphabet
    ACGTZ, Z a mod of A) as a mapped-signal file."""
    spec = importlib.util.spec_from_file_location(
        "tcm", os.path.join(REPO, "tests", "test_pallas_mesh_catmod.py"))
    tcm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tcm)
    reads = tcm.synth_mod_reads(np.random.default_rng(11), nreads=6,
                                nbases=300)
    ai = jalphabet.AlphabetInfo("ACGTZ", "ACGTA", mod_long_names=["5mZ"])
    with jmsf.MappedSignalWriter(path, ai) as w:
        for r in reads:
            w.write_read(r.get_read_dictionary())


def test_cli_mod_prior_factor_matches_jax(tmp_path):
    """--mod_prior_factor 0.5 on synthetic mod reads: the logged log-odds
    priors and their power equal the JAX trainer's, and so does the
    batch.log of the weighted loss."""
    mapped = str(tmp_path / "synth_mod.hdf5")
    _synth_mod_file(mapped)
    trained = _train_both(tmp_path, "mLstm_cat_mod_flipflop.py", mapped,
                          ["--mod_prior_factor", "0.5",
                           "--num_mod_weight_reads", "4"])
    lines = {}
    for tag, outdir in trained.items():
        with open(os.path.join(outdir, "model.log")) as fh:
            lines[tag] = [ln for ln in fh.read().splitlines()
                          if "modbase log odds priors" in ln]
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"]
    assert "Z:" in lines["port"][0]
    _batch_logs_match(trained)


# -- basecalling with --modified_base_output ---------------------------------

def _write_reads(path, lengths, seed=0):
    """A multi-read fast5 of synthetic step-like signals (h5py)."""
    import h5py
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f5:
        for i, n in enumerate(lengths):
            rid = "read{:02d}".format(i)
            levels = rng.normal(500.0, 60.0, size=n // 8 + 1)
            dacs = np.repeat(levels, 8)[:n] + rng.normal(0, 8.0, size=n)
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k, v in (("digitisation", 8192.0), ("offset", 4.0),
                         ("range", 1400.0), ("sampling_rate", 4000.0)):
                ch.attrs[k] = v
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = n
            raw.create_dataset("Signal", data=dacs.astype("i2"))


@pytest.fixture(scope="module")
def mod_checkpoint(tmp_path_factory):
    """A size-16 mLstm_cat_mod checkpoint written by the JAX package (the
    modref alphabet stored as a spec) and a read directory."""
    from taiyaki_tpu.utils import helpers as jhelpers
    d = tmp_path_factory.mktemp("modcall")
    jai, _ = _alphabets()
    kwargs = dict(insize=1, size=16, winlen=19, stride=5, alphabet_info=jai)
    net = jlstm.network(**kwargs)
    params = net.init(np.random.default_rng(27))   # calls some bases
    with open(jlstm.__file__) as fh:
        source = fh.read()
    model = jhelpers.save_model(str(d), net, params, source, kwargs,
                                {"reverse": False, "standardize": True,
                                 "version": 3})
    reads = d / "reads"
    reads.mkdir()
    _write_reads(str(reads / "batch0.fast5"), [170, 1200, 2900], seed=4)
    return d, model, str(reads)


def test_cli_modified_base_output_matches_jax(mod_checkpoint):
    """bin/basecall.py and the port's CLI with --modified_base_output:
    equal calls, equal mod_long_names, one mod row per called base, mod
    tables within 1e-4 (NaN where a mod does not apply)."""
    import h5py
    d, model, reads = mod_checkpoint
    out = {}
    for tag, cmd in (
            ("jax", [sys.executable, os.path.join(REPO, "bin", "basecall.py"),
                     "--ndevices", "1"]),
            ("port", [sys.executable, "-m",
                      "taiyaki_tpu_torch.cli.basecall"])):
        fa, mods = str(d / (tag + ".fa")), str(d / (tag + ".hdf5"))
        r = subprocess.run(cmd + [
            "--device", "cpu", "--chunk_size", "60", "--overlap", "10",
            "--max_concurrent_chunks", "4", "--quiet", "--output", fa,
            "--modified_base_output", mods, reads, model], cwd=REPO,
            env=_env(), capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        with open(fa) as fh:
            lines = fh.read().splitlines()
        calls = {lines[i][1:]: lines[i + 1] for i in range(0, len(lines), 2)}
        with h5py.File(mods, "r") as f:
            names = [n.decode() if isinstance(n, bytes) else n
                     for n in f["mod_long_names"][()]]
            tables = {k: f["Reads"][k][()] for k in f["Reads"]}
        out[tag] = calls, names, tables
    (jcalls, jnames, jtables), (tcalls, tnames, ttables) = (out["jax"],
                                                            out["port"])
    assert tcalls == jcalls and len(tcalls) == 3
    assert tnames == jnames == ["6mA", "5mC"]
    assert sorted(ttables) == sorted(jtables) == sorted(tcalls)
    for rid, table in ttables.items():
        assert table.dtype == np.float32
        assert table.shape == (len(tcalls[rid]), 2)
        np.testing.assert_allclose(table, jtables[rid], rtol=1e-4,
                                   atol=1e-4)
        assert np.isfinite(table).any()


def test_cli_modified_base_output_errors(mod_checkpoint, tmp_path):
    """The errors of bin/basecall.py: the beam decoder cannot give
    per-base mod scores, and a canonical model has none."""
    from taiyaki_tpu.models import mLstm_flipflop
    from taiyaki_tpu.utils import helpers as jhelpers
    from taiyaki_tpu_torch.cli import basecall
    _, model, reads = mod_checkpoint
    with pytest.raises(SystemExit, match="drop --beam"):
        basecall.main(["--device", "cpu", "--beam", "5", "false",
                       "--modified_base_output", str(tmp_path / "m.h5"),
                       reads, model])
    net = mLstm_flipflop.network(size=8)
    with open(mLstm_flipflop.__file__) as fh:
        source = fh.read()
    canonical = jhelpers.save_model(
        str(tmp_path), net, net.init(np.random.default_rng(0)), source,
        dict(insize=1, size=8, winlen=19, stride=5),
        {"reverse": False, "standardize": True, "version": 3})
    with pytest.raises(SystemExit, match="requires a cat_mod model"):
        basecall.main(["--device", "cpu", "--modified_base_output",
                       str(tmp_path / "m.h5"), reads, canonical])


def test_duplicate_read_id_keeps_the_first_mod_table(mod_checkpoint,
                                                     tmp_path, capsys):
    """One read id in two fast5 files: a record for each copy, one mod
    table (the first), and the warning of bin/basecall.py."""
    import h5py
    from taiyaki_tpu_torch.cli import basecall
    _, model, _ = mod_checkpoint
    reads = tmp_path / "dup"
    reads.mkdir()
    _write_reads(str(reads / "a.fast5"), [900], seed=3)
    _write_reads(str(reads / "b.fast5"), [900], seed=3)
    mods = str(tmp_path / "m.hdf5")
    fa = str(tmp_path / "c.fa")
    basecall.main(["--device", "cpu", "--chunk_size", "60", "--overlap",
                   "10", "--quiet", "--output", fa, "--modified_base_output",
                   mods, str(reads), model])
    assert "duplicate read id read00" in capsys.readouterr().err
    with h5py.File(mods, "r") as f:
        assert list(f["Reads"]) == ["read00"]
    with open(fa) as fh:
        assert fh.read().count(">read00") == 2


def test_mod_file_writer_reads_back_in_h5py(tmp_path):
    """The port writes its mod file with data.hdf5.Writer: fixed-length
    names, and tables that may be empty (a read with no called base),
    read back by h5py as written."""
    import h5py
    from taiyaki_tpu_torch.data import hdf5
    path = str(tmp_path / "m.hdf5")
    tables = {"a": np.zeros((0, 2), np.float32),
              "b": np.array([[np.nan, 0.5], [-1.0, np.nan]], np.float32)}
    with hdf5.Writer(path) as w:
        w.create_dataset("mod_long_names", data=np.array([b"6mA", b"5mC"]))
        grp = w.create_group("Reads")
        for k, v in tables.items():
            grp.create_dataset(k, data=v)
        assert "a" in grp and "c" not in grp
    with h5py.File(path, "r") as f:
        assert [n.decode() for n in f["mod_long_names"][()]] == ["6mA",
                                                                "5mC"]
        for k, v in tables.items():
            np.testing.assert_array_equal(f["Reads"][k][()], v)
