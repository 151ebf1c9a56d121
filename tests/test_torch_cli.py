"""The port's basecall CLI end to end on the CPU, against bin/basecall.py
(repeated read ids included; a real read with the shipped GRU
checkpoint); the import guard over every module of the port,
chip_smoke.py and chip_ab.py; the device default.

The JAX CLI runs once (a fixture whose run the xdist workers share), as
its compile dominates."""

import ast
import fcntl
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "taiyaki_tpu_torch")
FORBIDDEN = ("jax", "optax", "flax", "taiyaki_tpu")
CHUNK, OVERLAP = 60, 10          # blocks; stride 5 -> 300-sample chunks


def subprocess_env(one_jax_device=False):
    """The environment of a CLI subprocess: the CPU, the repo on the path,
    and one thread in each of PyTorch's and XLA's pools (the suite's xdist
    workers already fill the host's cores; pools sized to every core
    beside them make each small step many times slower).  With
    one_jax_device, the suite conftest's 8 virtual JAX devices are
    dropped: they would put bin/train_flipflop.py on its data-parallel
    mesh path with another batch size."""
    flags = os.environ.get("XLA_FLAGS", "").split()
    if one_jax_device:
        flags = [f for f in flags
                 if "xla_force_host_platform_device_count" not in f]
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1",
                XLA_FLAGS=" ".join(flags
                                   + ["--xla_cpu_multi_thread_eigen=false"]),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def shared_run(tmp_path_factory, name, make):
    """make(directory) once per pytest run, its (picklable) result shared
    by every xdist worker that asks for it: the first worker to take the
    lock runs it in `name` under the run's common base directory, the
    others wait and read its result.  (A module fixture runs again on
    every worker that picks a test of its module.)"""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the run's, above each worker's
    d, result = base / name, base / name / "result.pickle"
    with open(str(base / (name + ".lock")), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if result.exists():
            with open(str(result), "rb") as fh:
                return pickle.load(fh)
        shutil.rmtree(str(d), ignore_errors=True)
        d.mkdir()
        value = make(d)
        with open(str(result), "wb") as fh:
            pickle.dump(value, fh)
        return value


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a module's tests run in-process
    (modules that call the port on the CPU import this fixture): beside
    JAX's pools in the same worker, and the other workers, PyTorch's own
    pool makes each small op hundreds of times slower."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return subprocess_env()


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
    return shared_run(tmp_path_factory, "cli_calls", _call_both)


def _call_both(d):
    from taiyaki_tpu.models import mLstm_flipflop
    from taiyaki_tpu.utils import helpers as jhelpers

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


@pytest.mark.parametrize("flag", [["--beam", "5", "false",
                                   "--modified_base_output", "m.h5"],
                                  ["--modified_base_output", "m.h5"],
                                  ["--ndevices", "2", "--device", "cuda"]])
def test_cli_unported_options_stop(calls, flag):
    """Options stop where they cannot run: --modified_base_output on this
    canonical checkpoint, and with --beam on any, as bin/basecall.py
    does; --ndevices (ported) asking for more cards than the host has,
    with the JAX CLI's message."""
    import torch
    from taiyaki_tpu_torch.cli import basecall
    _, _, model, reads = calls
    why = {"--modified_base_output": "requires a cat_mod model",
           "--beam": "requires the Viterbi decoder",
           "--ndevices": "--ndevices 2 requested but only {} local devices"
                         .format(torch.cuda.device_count())}
    if flag[0] == "--ndevices" and torch.cuda.device_count() >= 2:
        pytest.skip("the host has two cards")
    with pytest.raises(SystemExit, match=why[flag[0]]):
        basecall.main(["--device", "cpu"] + flag + [reads, model])


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


REMAP_MODEL = os.path.join(REPO, "taiyaki_tpu", "models",
                           "mGru_flipflop_remapping_model_r9_DNA.checkpoint")


def write_real_read(reads):
    """The shortest real read of the repo's mapped reads (19 039 samples)
    as reads/real.fast5 (h5py); returns (read id, reference)."""
    import h5py
    src = os.path.join(REPO, "RESULTS", "training_ingredients",
                       "mapped_remap_samref.hdf5")
    with h5py.File(src, "r") as f:
        rid = min(f["Reads"], key=lambda k: len(f["Reads"][k]["Dacs"]))
        g = f["Reads"][rid]
        dacs = g["Dacs"][()]
        ref = "".join("ACGT"[i] for i in g["Reference"][()])
        with h5py.File(os.path.join(str(reads), "real.fast5"), "w") as out:
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
    return rid, ref


def test_real_read_calls_match_jax_on_shipped_gru_checkpoint(tmp_path):
    """The shortest real read of the repo's mapped reads (19 039
    samples), written as fast5 with h5py, called with the shipped
    mGru_flipflop remap checkpoint (size 96, stride 4) by both CLIs with
    their defaults but for batches of 8 chunks (the read has 6; the JAX
    CLI pads every batch to the batch size): the fastas are equal byte for
    byte, and the call's semi-global identity against the read's
    reference is the JAX call's 0.870 (at least 0.80)."""
    reads = tmp_path / "reads"
    reads.mkdir()
    rid, ref = write_real_read(reads)
    model = REMAP_MODEL
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
    yield os.path.join(REPO, "chip_ab.py")


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
            "taiyaki_tpu_torch.models.mLstm_cat_mod_flipflop, "
            "taiyaki_tpu_torch.models.mGru_cat_mod_flipflop, "
            "taiyaki_tpu_torch.ops.gru, "
            "taiyaki_tpu_torch.utils.helpers, "
            "taiyaki_tpu_torch.cli.dump_json, taiyaki_tpu_torch.decodeutil, "
            "taiyaki_tpu_torch.flipflop_remap, taiyaki_tpu_torch.layers, "
            "taiyaki_tpu_torch.utils.json, "
            "taiyaki_tpu_torch.cli.prepare_mapped_reads, "
            "taiyaki_tpu_torch.cli.get_refs_from_sam, "
            "taiyaki_tpu_torch.cli.generate_per_read_params, "
            "taiyaki_tpu_torch.prepare_mapping_funcs, taiyaki_tpu_torch.bio, "
            "taiyaki_tpu_torch.sam, taiyaki_tpu_torch.iterators, "
            "taiyaki_tpu_torch.data.signal_mapping, "
            "taiyaki_tpu_torch.data.hdf5, taiyaki_tpu_torch.loss, "
            "taiyaki_tpu_torch.ops.squiggle, "
            "taiyaki_tpu_torch.cli.train_squiggle, "
            "taiyaki_tpu_torch.cli.predict_squiggle, "
            "taiyaki_tpu_torch.cli.map_to_squiggle, "
            "taiyaki_tpu_torch.cli.train_abinitio, "
            "taiyaki_tpu_torch.cli.align, "
            "taiyaki_tpu_torch.cli.assess_alignment, "
            "taiyaki_tpu_torch.cli.check_mapped_signal_file, "
            "taiyaki_tpu_torch.cli.merge_mappedsignalfiles, "
            "taiyaki_tpu_torch.cli."
            "convert_alphabet_or_inspect_mapped_signal_file, "
            "taiyaki_tpu_torch.cli.upgrade_mapped_signal, "
            "taiyaki_tpu_torch.cli.synth_dataset, "
            "taiyaki_tpu_torch.cli.upgrade_model, "
            "taiyaki_tpu_torch.cli.json_to_checkpoint, "
            "taiyaki_tpu_torch.cli.import_torch_checkpoint, "
            "taiyaki_tpu_torch.parallel.mesh, "
            "taiyaki_tpu_torch.utils.hostsync, "
            "taiyaki_tpu_torch.utils.plotting, "
            "taiyaki_tpu_torch.cli.split_strandlist, "
            "taiyaki_tpu_torch.cli.check_hdf5_contents, "
            "taiyaki_tpu_torch.cli.motif, "
            "taiyaki_tpu_torch.cli.calibrate_qscores_byread, "
            "taiyaki_tpu_torch.cli.plot_training, "
            "taiyaki_tpu_torch.cli."
            "plot_accuracy_histogram_from_alignment_summary, "
            "taiyaki_tpu_torch.cli.plot_mapped_signals, "
            "taiyaki_tpu_torch.cli.plot_predict_squiggle_output; "
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
