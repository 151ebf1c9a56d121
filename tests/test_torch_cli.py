"""The port's basecall CLI end to end on the CPU, against bin/basecall.py
(repeated read ids included; a real read with the shipped GRU
checkpoint); the import guard over every module of the port and
chip_smoke.py; the device default.

The JAX CLI runs once (module fixture), as its compile dominates."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "taiyaki_tpu_torch")
FORBIDDEN = ("jax", "optax", "flax", "taiyaki_tpu")
CHUNK, OVERLAP = 60, 10          # blocks; stride 5 -> 300-sample chunks


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def write_reads(path, lengths, seed=0):
    """A multi-read fast5 of synthetic step-like signals (h5py)."""
    import h5py
    rng = np.random.default_rng(seed)
    ids = []
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
            ids.append(rid)
    return ids


def read_calls(path, fastq):
    with open(path) as fh:
        lines = fh.read().splitlines()
    step = 4 if fastq else 2
    out = {}
    for i in range(0, len(lines), step):
        out[lines[i][1:]] = (lines[i + 1], lines[i + 3] if fastq else None)
    return out


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """A size-16 mLstm checkpoint written by the JAX package, 3 reads
    (one shorter than a chunk, one of several chunks), called by both
    CLIs with --fastq."""
    from taiyaki_tpu.models import mLstm_flipflop
    from taiyaki_tpu.utils import helpers as jhelpers

    d = tmp_path_factory.mktemp("cli")
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    net = mLstm_flipflop.network(**kwargs)
    params = net.init(np.random.default_rng(5))
    with open(mLstm_flipflop.__file__) as fh:
        source = fh.read()
    model = jhelpers.save_model(str(d), net, params, source, kwargs,
                                {"reverse": False, "standardize": True,
                                 "version": 3})
    reads = d / "reads"
    reads.mkdir()
    ids = write_reads(str(reads / "batch0.fast5"), [170, 1200, 2900])
    common = ["--device", "cpu", "--fastq", "--chunk_size", str(CHUNK),
              "--overlap", str(OVERLAP), "--max_concurrent_chunks", "4",
              "--quiet", str(reads), model]
    out = {}
    for tag, cmd in (
            ("jax", [sys.executable, os.path.join(REPO, "bin", "basecall.py"),
                     "--ndevices", "1"]),
            ("port", [sys.executable, "-m",
                      "taiyaki_tpu_torch.cli.basecall"])):
        path = str(d / (tag + ".fq"))
        r = subprocess.run(cmd + ["--output", path] + common, cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        out[tag] = read_calls(path, fastq=True)
    return ids, out, model, str(reads)


def test_cli_calls_every_read(calls):
    ids, out, _, _ = calls
    assert sorted(out["port"]) == sorted(out["jax"]) == ids
    for seq, qual in out["port"].values():
        assert len(seq) == len(qual) > 0
        assert set(seq) <= set("ACGT")


def test_cli_sequences_match_jax(calls):
    _, out, _, _ = calls
    for rid, (seq, _) in out["jax"].items():
        assert out["port"][rid][0] == seq, rid


def test_cli_qscores_match_jax_within_one(calls):
    _, out, _, _ = calls
    for rid, (_, qual) in out["jax"].items():
        q_port = np.frombuffer(out["port"][rid][1].encode(), np.uint8)
        q_jax = np.frombuffer(qual.encode(), np.uint8)
        assert np.abs(q_port.astype(int) - q_jax).max() <= 1, rid


def test_cli_fasta_matches_fastq_calls(calls, tmp_path):
    _, out, model, reads = calls
    path = str(tmp_path / "port.fa")
    r = subprocess.run(
        [sys.executable, "-m", "taiyaki_tpu_torch.cli.basecall", "--device",
         "cpu", "--chunk_size", str(CHUNK), "--overlap", str(OVERLAP),
         "--max_concurrent_chunks", "2", "--quiet", "--output", path,
         reads, model], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    fasta = read_calls(path, fastq=False)
    assert {k: v[0] for k, v in fasta.items()} == \
        {k: v[0] for k, v in out["port"].items()}


def test_cli_default_device_is_cuda(calls):
    """With no --device the CLI asks for the card; without one it exits
    non-zero naming CUDA."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, model, reads = calls
    r = subprocess.run(
        [sys.executable, "-m", "taiyaki_tpu_torch.cli.basecall", reads,
         model], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr


@pytest.mark.parametrize("flag", [["--beam", "5", "false"],
                                  ["--modified_base_output", "m.h5"],
                                  ["--ndevices", "2"]])
def test_cli_unported_options_stop(calls, flag):
    from taiyaki_tpu_torch.cli import basecall
    _, _, model, reads = calls
    with pytest.raises(SystemExit, match="not ported"):
        basecall.main(flag + ["--device", "cpu", reads, model])


def test_duplicate_read_ids_get_a_record_each(calls, tmp_path):
    """One read id in two fast5 files: both CLIs write a record for each
    copy, and their fastas are identical."""
    _, _, model, _ = calls
    reads = tmp_path / "dup"
    reads.mkdir()
    write_reads(str(reads / "a.fast5"), [900, 1300], seed=3)
    write_reads(str(reads / "b.fast5"), [900], seed=3)
    common = ["--device", "cpu", "--chunk_size", str(CHUNK), "--overlap",
              str(OVERLAP), "--quiet", str(reads), model]
    text = {}
    for tag, cmd in (
            ("jax", [sys.executable, os.path.join(REPO, "bin", "basecall.py"),
                     "--ndevices", "1"]),
            ("port", [sys.executable, "-m",
                      "taiyaki_tpu_torch.cli.basecall"])):
        path = str(tmp_path / (tag + ".fa"))
        r = subprocess.run(cmd + ["--output", path] + common, cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        with open(path) as fh:
            text[tag] = fh.read()
    headers = [line for line in text["port"].splitlines()
               if line.startswith(">")]
    assert sorted(headers) == [">read00", ">read00", ">read01"]
    assert text["port"] == text["jax"]


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_real_read_calls_match_jax_on_shipped_gru_checkpoint(tmp_path):
    """The shortest real read of the repo's mapped reads (19 039
    samples), written as fast5 with h5py, called with the shipped
    mGru_flipflop remap checkpoint (size 96, stride 4) by both CLIs with
    their defaults but for batches of 8 chunks (the read has 6; the JAX
    CLI pads every batch to the batch size): the fastas are equal byte for
    byte, and the call's semi-global identity against the read's
    reference is the JAX call's 0.870 (at least 0.80)."""
    import h5py
    reads = tmp_path / "reads"
    reads.mkdir()
    src = os.path.join(REPO, "RESULTS", "training_ingredients",
                       "mapped_remap_samref.hdf5")
    with h5py.File(src, "r") as f:
        rid = min(f["Reads"], key=lambda k: len(f["Reads"][k]["Dacs"]))
        g = f["Reads"][rid]
        dacs = g["Dacs"][()]
        ref = "".join("ACGT"[i] for i in g["Reference"][()])
        with h5py.File(str(reads / "real.fast5"), "w") as out:
            grp = out.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k in ("digitisation", "offset", "range"):
                ch.attrs[k] = g.attrs[k]
            ch.attrs["sampling_rate"] = 4000.0
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = len(dacs)
            raw.create_dataset("Signal", data=dacs.astype("i2"))
    assert len(dacs) == 19039
    model = os.path.join(REPO, "taiyaki_tpu", "models",
                         "mGru_flipflop_remapping_model_r9_DNA.checkpoint")
    text = {}
    for tag, cmd in (
            ("jax", [sys.executable, os.path.join(REPO, "bin", "basecall.py"),
                     "--ndevices", "1"]),
            ("port", [sys.executable, "-m",
                      "taiyaki_tpu_torch.cli.basecall"])):
        path = str(tmp_path / (tag + ".fa"))
        r = subprocess.run(cmd + ["--device", "cpu", "--quiet",
                                  "--max_concurrent_chunks", "8", "--output",
                                  path, str(reads), model], cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        with open(path) as fh:
            text[tag] = fh.read()
    assert text["port"] == text["jax"]
    header, call = text["port"].split()
    assert header == ">" + rid
    identity = _chip_smoke().semiglobal_identity(call, ref)
    assert identity >= 0.80
    assert round(identity, 3) == 0.870


def test_semiglobal_identity_counts_edits_against_the_reference():
    ident = _chip_smoke().semiglobal_identity
    assert ident("ACGTACGT", "ACGTACGT") == 1.0
    # the call's overhanging ends are free; the reference is not
    assert ident("TTTACGTACGTGG", "ACGTACGT") == 1.0
    assert ident("ACGTACGT", "TTACGTACGT") == 0.8
    assert ident("ACGAACGT", "ACGTACGT") == 1 - 1 / 8     # substitution
    assert ident("ACGTTACGT", "ACGTACGT") == 1 - 1 / 8    # insertion
    assert ident("ACGACGT", "ACGTACGT") == 1 - 1 / 8      # deletion


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += ["{}: {}".format(os.path.relpath(path, REPO), n)
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, taiyaki_tpu_torch.cli.basecall, "
            "taiyaki_tpu_torch.cli.train_flipflop, taiyaki_tpu_torch.train, "
            "taiyaki_tpu_torch.ops.crf, taiyaki_tpu_torch.ops.rnn, "
            "taiyaki_tpu_torch.data.mapped_signal_files, "
            "taiyaki_tpu_torch.data.chunk_selection, "
            "taiyaki_tpu_torch.models.mLstm_flipflop, "
            "taiyaki_tpu_torch.models.mGru_flipflop, "
            "taiyaki_tpu_torch.ops.gru, "
            "taiyaki_tpu_torch.utils.helpers; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in {!r}))".format(FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_checkpoint_loads_through_import_mapping(calls):
    """The stored model source names taiyaki_tpu; the port runs it with
    its own package and never imports the JAX one."""
    _, _, model, _ = calls
    code = ("import sys; from taiyaki_tpu_torch.utils import helpers; "
            "net, p, src, *_ = helpers.load_model({!r}); "
            "assert 'from taiyaki_tpu import' in src; "
            "assert type(net).__module__ == 'taiyaki_tpu_torch.layers'; "
            "print('taiyaki_tpu' in sys.modules)".format(model))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
