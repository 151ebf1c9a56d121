"""The port's eight analysis tools on the CPU against their misc/
namesakes, on inputs from the repo (RESULTS/training_ingredients) or made
here from a seed: split_strandlist, check_hdf5_contents, motif,
calibrate_qscores_byread and the four plot_* tools.  The JAX tools run in
process; the port's too, and again in a subprocess with matplotlib and
h5py hidden (as on the card's host).

Text outputs are equal; calibrate_qscores_byread's slope and shift agree
to 1e-6; a plot is a non-empty PNG.  Where matplotlib is hidden a pure
plotting tool exits non-zero naming it and writes no file, and
calibrate_qscores_byread prints its fit, says on stderr that no plot was
written and exits 0; check_hdf5_contents lists the same tree through
data/hdf5.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import subprocess_env, write_reads
from test_torch_msf_tools import run_jax, run_port
from test_torch_seqalign import misc_module
from taiyaki_tpu_torch.cli import (
    calibrate_qscores_byread as tcalibrate, check_hdf5_contents as tcheck,
    motif as tmotif, plot_accuracy_histogram_from_alignment_summary as
    thist, plot_mapped_signals as tmapped, plot_predict_squiggle_output as
    tsquiggle, plot_training as ttraining, split_strandlist as tsplit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INGREDIENTS = os.path.join(REPO, "RESULTS", "training_ingredients")
SAMREF = os.path.join(INGREDIENTS, "mapped_remap_samref.hdf5")
REFS = os.path.join(INGREDIENTS, "per_read_references_from_sam.fa")
HIDE = ("import runpy, sys; sys.modules['matplotlib'] = None; "
        "sys.modules['h5py'] = None; sys.argv = sys.argv[1:]; "
        "runpy.run_module(sys.argv[0], run_name='__main__')")


def hidden(name, argv, cwd):
    """`python -m taiyaki_tpu_torch.cli.<name> argv` with matplotlib and
    h5py hidden: (exit code, stdout, stderr)."""
    r = subprocess.run(
        [sys.executable, "-c", HIDE, "taiyaki_tpu_torch.cli." + name]
        + list(argv), cwd=str(cwd), env=subprocess_env(),
        capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout, r.stderr


def is_png(path):
    with open(str(path), "rb") as fh:
        head = fh.read(8)
    return head == b"\x89PNG\r\n\x1a\n" and os.path.getsize(str(path)) > 100


def _read_ids():
    from taiyaki_tpu_torch.data.mapped_signal_files import MappedSignalReader
    with MappedSignalReader(SAMREF) as msr:
        return msr.get_read_ids()


# -- split_strandlist ---------------------------------------------------------

@pytest.mark.parametrize("nparts", [2, 3, 5])
def test_split_strandlist(tmp_path, monkeypatch, capsys, nparts):
    ids = _read_ids()
    src = tmp_path / "strands.tsv"
    src.write_text("read_id\tfilename\n" + "".join(
        "{}\treads_{}.fast5\n".format(r, i % 3) for i, r in enumerate(ids)))
    res = {}
    for tag, run in (("jax", lambda a: run_jax("split_strandlist", a,
                                               monkeypatch, capsys)),
                     ("port", lambda a: run_port(tsplit.main, a, capsys))):
        (tmp_path / tag).mkdir()
        prefix = str(tmp_path / tag / "part")
        code, out, err = run(["--nparts", str(nparts), "--prefix", prefix,
                              str(src)])
        assert code == 0
        res[tag] = ([(tmp_path / tag / "part_part{}.tsv".format(i))
                     .read_text() for i in range(nparts)],
                    out, err.replace(tag, ""))
    assert res["port"] == res["jax"]
    assert "".join(p.split("\n", 1)[1] for p in res["port"][0]) == \
        src.read_text().split("\n", 1)[1]


# -- check_hdf5_contents ------------------------------------------------------

def _hdf5_inputs(d):
    """The repo's mapped reads, a fast5 written with h5py and one written
    by the port's hdf5.Writer."""
    from taiyaki_tpu_torch.data import hdf5
    h5 = str(d / "h5py.fast5")
    write_reads(h5, [500, 900])
    mine = str(d / "writer.fast5")
    with hdf5.Writer(mine) as f:
        f.attrs["file_version"] = np.float64(2.0)
        g = f.create_group("read_a")
        g.attrs["run_id"] = "abc"
        g.attrs["count"] = np.int32(7)
        g.create_dataset("Signal", data=np.arange(10, dtype="i2"))
        g.create_dataset("names", data=np.array([b"ab", b"cd"]))
        f.create_dataset("scalar", data=np.float32(1.5))
    return [SAMREF, h5, mine]


def test_check_hdf5_contents(tmp_path, monkeypatch, capsys):
    for path in _hdf5_inputs(tmp_path):
        want = run_jax("check_hdf5_contents", [path], monkeypatch, capsys)
        assert want[0] == 0 and want[1].count("\n") > 2
        assert run_port(tcheck.main, [path], capsys) == want
        assert hidden("check_hdf5_contents", [path], tmp_path) == want


# -- motif --------------------------------------------------------------------

def _coordinates(d, seed=0):
    """Sites on the repo's three references (seeded), with a read not in
    the fasta and sites too near either end."""
    from taiyaki_tpu_torch.bio import fasta_file_to_dict
    rng = np.random.default_rng(seed)
    refs = fasta_file_to_dict(REFS)
    rows = []
    for name, seq in sorted(refs.items()):
        rows += [(name, int(p)) for p in rng.integers(20, len(seq) - 20, 30)]
        rows += [(name, 3), (name, len(seq) - 2)]
    rows.append(("not_a_read", 100))
    path = d / "coords.tsv"
    path.write_text("filename\tpos\n" + "".join(
        "{}\t{}\n".format(*r) for r in rows))
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--refbackground"],
                                   ["--up", "4", "--down", "6"]])
def test_motif(tmp_path, monkeypatch, capsys, extra):
    argv = extra + [REFS, _coordinates(tmp_path)]
    want = run_jax("motif", argv, monkeypatch, capsys)
    assert want[0] == 0 and want[1].count("\n") > 8
    assert run_port(tmotif.main, argv, capsys) == want
    assert hidden("motif", argv, tmp_path) == want


def test_motif_no_reads(tmp_path, monkeypatch, capsys):
    coords = tmp_path / "none.tsv"
    coords.write_text("filename\tpos\nnot_a_read\t100\nnor_this\t50\n")
    argv = [REFS, str(coords)]
    want = run_jax("motif", argv, monkeypatch, capsys)
    assert want[1] == "No reads\n"
    assert run_port(tmotif.main, argv, capsys) == want


# -- calibrate_qscores_byread -------------------------------------------------

def _calibration_inputs(d, seed=0, n=60):
    """A fastq of n reads whose mean q-scores follow their accuracies
    (plus noise), and the matching .samacc (cli.assess_alignment's
    columns, space-separated) and Guppy summary; a few reads are short
    on coverage or below the q floor, and one is missing from the
    alignments."""
    rng = np.random.default_rng(seed)
    fq, samacc, guppy = [], [], []
    for i in range(n):
        rid = "read{:03d}".format(i)
        length = int(rng.integers(400, 1200))
        acc = float(np.clip(rng.normal(0.9, 0.05), 0.6, 0.999))
        q = -10 * np.log10(1 - acc) * 0.8 + rng.normal(0, 1.5)
        quals = np.clip(np.round(rng.normal(q, 4, length)), 1, 60)
        fq.append("@{}\n{}\n+\n{}\n".format(
            rid, "".join(rng.choice(list("ACGT"), length)),
            "".join(chr(int(v) + 33) for v in quals)))
        if i == n - 1:
            continue
        cover = length if i % 7 else length // 2
        samacc.append("ref{} {} + 100 {} {} {} 3 2 0.95 0.9 {} 1000.0\n"
                      .format(i, rid, 100 + cover, cover, 5, acc))
        guppy.append("{}\t{}\t0\t{}\n".format(rid, acc, cover))
    paths = [d / "calls.fastq", d / "calls.samacc", d / "guppy.txt"]
    paths[0].write_text("".join(fq))
    paths[1].write_text(
        "reference query strand reference_start reference_end match "
        "mismatch insertion deletion coverage id accuracy information\n"
        + "".join(samacc))
    paths[2].write_text("read_id\talignment_accuracy\t"
                        "alignment_strand_start\talignment_strand_end\n"
                        + "".join(guppy))
    return [str(p) for p in paths]


def _fit(out):
    lines = [line for line in out.splitlines() if "Best-fit s" in line]
    return [float(line.rsplit("=", 1)[1]) for line in lines]


@pytest.mark.parametrize("summary", ["samacc", "guppy"])
def test_calibrate_qscores_byread(tmp_path, monkeypatch, capsys, summary):
    fastq, samacc, guppy = _calibration_inputs(tmp_path)
    res = {}
    for tag in ("jax", "port"):
        png = str(tmp_path / (tag + ".png"))
        argv = ["--fastq", fastq, "--alignment_summary",
                samacc if summary == "samacc" else guppy,
                "--plot_title", "run", "--plot_filename", png]
        res[tag] = (run_jax("calibrate_qscores_byread", argv, monkeypatch,
                            capsys) if tag == "jax" else
                    run_port(tcalibrate.main, argv, capsys))
        assert res[tag][0] == 0 and is_png(png)
    assert res["port"][1].replace("port.png", "jax.png") == res["jax"][1]
    assert len(_fit(res["port"][1])) == 2
    # the fit itself, unrounded
    jax_mod = misc_module("calibrate_qscores_byread")
    x = np.random.default_rng(1).normal(20, 3, 200)
    y = 0.9 * x + 2 + np.random.default_rng(2).standard_t(2, 200)
    np.testing.assert_allclose(tcalibrate.huber_regression(x, y),
                               jax_mod.huber_regression(x, y), rtol=0,
                               atol=1e-6)
    # matplotlib hidden: the same fit, no plot, exit 0
    png = tmp_path / "hidden.png"
    code, out, err = hidden("calibrate_qscores_byread", [
        "--fastq", fastq, "--alignment_summary", samacc,
        "--plot_title", "run", "--plot_filename", str(png)], tmp_path)
    assert code == 0 and not png.exists()
    assert "matplotlib is not installed: no plot written" in err
    assert _fit(out) == _fit(res["port"][1])


# -- the plot_* tools ---------------------------------------------------------

def _training_dirs(d, seed=0):
    rng = np.random.default_rng(seed)
    dirs = []
    for k, nval in (("run_a", 3), ("run_b", 0)):
        td = d / k
        td.mkdir()
        rows = "".join("{}\t{}\t1.0\tNA\t0.001\t4000\n".format(
            i + 1, 1.5 - 0.01 * i + rng.normal(0, 0.05)) for i in range(40))
        (td / "batch.log").write_text(
            "iter\tloss\tgradientmax\tgradientcap\tlearning_rate\t"
            "chunk_len\n" + rows)
        (td / "validation.log").write_text("iter\tloss\n" + "".join(
            "{}\t{}\n".format(10 * (i + 1), 1.2 - 0.05 * i)
            for i in range(nval)))
        dirs.append(str(td))
    return dirs


def _accuracy_summary(d, seed=0):
    rng = np.random.default_rng(seed)
    acc = np.clip(rng.normal(0.88, 0.05, 300), 0, 1)
    acc[::17] = -1.0
    path = d / "summary.tsv"
    path.write_text("read_id\talignment_accuracy\n" + "".join(
        "r{}\t{}\n".format(i, a) for i, a in enumerate(acc)))
    return str(path)


def _squiggle_tsv(d, seed=0):
    rng = np.random.default_rng(seed)
    path = d / "squiggle.tsv"
    path.write_text("base\tcurrent\tsd\tdwell\n" + "".join(
        "{}\t{}\t{}\t{}\n".format(b, rng.normal(0, 1), abs(rng.normal(
            0.2, 0.05)), rng.integers(2, 15))
        for b in rng.choice(list("ACGT"), 40)))
    return str(path)


def _plot_cases(d):
    """(tool, port main, argv with OUT for the PNG)."""
    return [
        ("plot_training", ttraining.main,
         ["--mav", "5", "OUT"] + _training_dirs(d)),
        ("plot_accuracy_histogram_from_alignment_summary", thist.main,
         [_accuracy_summary(d), "--bins", "30", "--title", "acc\\n2",
          "--output_name", "OUT"]),
        ("plot_mapped_signals", tmapped.main,
         ["--output", "OUT", "--nreads", "4", "--zero_signal_start",
          "--xmin", "10", SAMREF, SAMREF]),
        ("plot_predict_squiggle_output", tsquiggle.main,
         [_squiggle_tsv(d), "OUT"]),
    ]


@pytest.mark.parametrize("which", range(4))
def test_plot_tools(tmp_path, monkeypatch, capsys, which):
    name, main, argv = _plot_cases(tmp_path)[which]
    res = {}
    for tag in ("jax", "port"):
        png = str(tmp_path / (tag + ".png"))
        args = [png if a == "OUT" else a for a in argv]
        res[tag] = (run_jax(name, args, monkeypatch, capsys)
                    if tag == "jax" else run_port(main, args, capsys))
        assert res[tag][0] == 0, res[tag]
        assert is_png(png)
    code, out, err = res["port"]
    assert (code, out.replace("port.png", "jax.png"),
            err.replace("port.png", "jax.png")) == res["jax"]
    png = tmp_path / "hidden.png"
    code, out, err = hidden(name, [str(png) if a == "OUT" else a
                                   for a in argv], tmp_path)
    assert code != 0 and "matplotlib" in err and not png.exists()


def test_plot_mapped_signals_summaries_and_read_ids(tmp_path, monkeypatch,
                                                    capsys):
    """Without --output only the summaries, also with matplotlib and h5py
    hidden; --read_ids in their order, an absent one named."""
    ids = _read_ids()
    for argv in (["--nreads", "5", SAMREF],
                 ["--read_ids", ids[2], "absent_read", ids[0], "--",
                  SAMREF]):
        want = run_jax("plot_mapped_signals", argv, monkeypatch, capsys)
        assert want[0] == 0 and want[1].count("\n") >= 2
        assert run_port(tmapped.main, argv, capsys) == want
        assert hidden("plot_mapped_signals", argv, tmp_path) == want


def test_plot_predict_squiggle_output_usage(monkeypatch, capsys):
    """Fewer than two arguments: the usage and the error line, exit 0."""
    want = run_jax("plot_predict_squiggle_output", [], monkeypatch, capsys)
    assert run_port(tsquiggle.main, [], capsys) == want
    assert "ERROR: Needs command line arguments!" in want[1]
