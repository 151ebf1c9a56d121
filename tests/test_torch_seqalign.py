"""The port's aligner and alignment tools on the CPU against the JAX
package's: `decodeutil.seq_align` against `taiyaki_tpu.decodeutil.seq_align`
on seeded pairs, `cli.align.builtin_align` against misc/align.py's (the
same SAM but the @PG line), `cli.assess_alignment`'s `samacc` and
`summary` against misc/assess_alignment.py's, and both align CLIs on one
fasta, with matplotlib and with it hidden (no plot, the same text)."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from taiyaki_tpu import decodeutil as jdu
from taiyaki_tpu_torch import decodeutil as tdu
from taiyaki_tpu_torch.cli import align as talign
from taiyaki_tpu_torch.cli import assess_alignment as tassess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP = str.maketrans("ACGT", "TGCA")


def misc_module(name):
    """A misc/ script of the JAX package, imported under its own name."""
    spec = importlib.util.spec_from_file_location(
        "jax_misc_" + name, os.path.join(REPO, "misc", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mutate(rng, seq, rate):
    out = []
    for b in seq:
        r = rng.random()
        if r < rate:
            out.append("ACGT"[rng.integers(4)])
        elif r < 1.5 * rate:
            continue
        elif r < 2 * rate:
            out += [b, "ACGT"[rng.integers(4)]]
        else:
            out.append(b)
    return "".join(out)


def _pairs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ref = "".join(rng.choice(list("ACGTN"), rng.integers(0, 401),
                                 p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        lo = int(rng.integers(0, len(ref) + 1))
        hi = int(rng.integers(lo, len(ref) + 1))
        query = _mutate(rng, ref[lo:hi], float(rng.uniform(0, 0.15)))
        if rng.random() < 0.5:
            query = query.translate(COMP)[::-1]
        yield query, ref


def test_seq_align_matches_jax():
    """Equal tuples on 200 seeded pairs (lengths 0-400, mutated, either
    strand, an N now and then); an empty query or reference raises in
    both packages."""
    nempty = 0
    for query, ref in _pairs():
        if not query or not ref:
            nempty += 1
            for fn in (jdu.seq_align, tdu.seq_align):
                with pytest.raises(RuntimeError, match="alignment failed"):
                    fn(query, ref)
            continue
        assert tdu.seq_align(query, ref) == jdu.seq_align(query, ref)
    assert 0 < nempty < 50


@pytest.mark.parametrize("scores", [(1, 2, 2, 1), (2, 3, 5, 2)])
def test_seq_align_scores_match_jax(scores):
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 300))
    query = _mutate(rng, ref[40:260], 0.1)
    assert tdu.seq_align(query, ref, *scores) == jdu.seq_align(
        query, ref, *scores)


def _three_queries(d):
    """tests/test_seqalign.py's case: an exact slice, a reverse-complement
    slice and a 5%-mutated slice of one 800-base reference."""
    rng = np.random.RandomState(7)
    bases = "ACGT"
    ref = "".join(rng.choice(list(bases), 800))
    q3 = "".join(b if rng.rand() > 0.05 else bases[rng.randint(4)]
                 for b in ref[100:700])
    genome = d / "refs.fa"
    genome.write_text(">ref1\n{}\n".format(ref))
    queries = d / "reads.fa"
    queries.write_text(">q1\n{}\n>q2\n{}\n>q3\n{}\n".format(
        ref[200:600], ref[150:650].translate(COMP)[::-1], q3))
    return str(queries), str(genome)


def _sam_lines(path):
    with open(path) as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith("@PG")]


def test_builtin_align_matches_jax(tmp_path):
    queries, genome = _three_queries(tmp_path)
    jalign = misc_module("align")
    jalign.builtin_align(queries, str(tmp_path / "jax.sam"), genome)
    talign.builtin_align(queries, str(tmp_path / "port.sam"), genome)
    assert _sam_lines(tmp_path / "port.sam") == _sam_lines(
        tmp_path / "jax.sam")
    with open(tmp_path / "port.sam") as fh:
        assert ("@PG\tID:seq_align\tPN:taiyaki_tpu_torch.decodeutil."
                "seq_align\n") in fh.read()
    recs = {line.split("\t")[0]: line.split("\t")
            for line in _sam_lines(tmp_path / "port.sam")
            if not line.startswith("@")}
    assert [recs[q][1] for q in ("q1", "q2", "q3")] == ["0", "16", "0"]


def test_samacc_and_summary_match_jax(tmp_path):
    queries, genome = _three_queries(tmp_path)
    sam = str(tmp_path / "reads.sam")
    talign.builtin_align(queries, sam, genome)
    jassess = misc_module("assess_alignment")
    for cov in (0.6, 0.95):
        jrecs = jassess.samacc(sam, min_coverage=cov)
        trecs = tassess.samacc(sam, min_coverage=cov)
        assert tassess.ACC_METRICS._fields == jassess.ACC_METRICS._fields
        assert [tuple(r) for r in trecs] == [tuple(r) for r in jrecs]
        accs = {r.query: r for r in trecs}
        assert accs["q1"].accuracy == 1.0 and accs["q1"].strand == "+"
        assert accs["q2"].accuracy == 1.0 and accs["q2"].strand == "-"
        assert 0.9 < accs["q3"].accuracy < 1.0
    import matplotlib.pyplot as plt
    for recs, median in ((trecs, False), (trecs, True), (trecs[:1], True),
                         ([], False)):
        jreport, f, _ = jassess.summary(recs, "set", median, [5, 50, 95])
        if f is not None:
            plt.close(f)
        treport, plot = tassess.summary(recs, "set", median, [5, 50, 95])
        assert treport == jreport
        assert (plot is None) == (not recs)


def _run_align(main, argv, capsys):
    """A CLI's main in process: (exit code, stdout), and stderr."""
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return (code or 0, out), err


@pytest.mark.parametrize("hide_matplotlib", [False, True])
def test_align_cli_matches_jax(tmp_path, monkeypatch, capsys,
                               hide_matplotlib):
    """misc/align.py and `cli.align` on the same fasta (built-in aligner):
    equal .samacc and .summary and stdout; with matplotlib hidden from the
    port, no plot, the same text, and stderr says so."""
    monkeypatch.setattr(talign, "_have_bwa", lambda: False)
    outs, errs = {}, {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        _three_queries(d)
        # the same relative names: stdout and the reports name the files
        monkeypatch.chdir(d)
        queries, genome = "reads.fa", "refs.fa"
        if name == "jax":
            jalign = misc_module("align")
            monkeypatch.setattr(jalign, "_have_bwa", lambda: False)
            monkeypatch.setattr(sys, "argv", ["align.py", queries,
                                              "--reference", genome])
            outs[name], errs[name] = _run_align(lambda argv: jalign.main(),
                                                None, capsys)
        else:
            if hide_matplotlib:
                monkeypatch.setitem(sys.modules, "matplotlib", None)
            outs[name], errs[name] = _run_align(
                talign.main, [queries, "--reference", genome], capsys)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0
    assert "Mean accuracy:" in outs["port"][1]
    for ext in ("sam", "samacc", "summary"):
        with open(tmp_path / "jax" / ("reads." + ext)) as fh:
            want = fh.read()
        with open(tmp_path / "port" / ("reads." + ext)) as fh:
            got = fh.read()
        if ext == "sam":
            got = got.replace("taiyaki_tpu_torch.", "taiyaki_tpu.")
        assert got == want
    assert (tmp_path / "jax" / "reads.png").exists()
    assert (tmp_path / "port" / "reads.png").exists() != hide_matplotlib
    if hide_matplotlib:
        assert "no plot written" in errs["port"]


def test_assess_cli_exit_codes(tmp_path, capsys):
    """A missing file fails (exit 1) and the next is still assessed; a SAM
    with nothing mapped writes the empty report and no .samacc."""
    sam = tmp_path / "empty.sam"
    sam.write_text("@HD\tVN:1.6\n@SQ\tSN:r\tLN:10\nq\t4\t*\t0\t0\t*\t*\t0\t0"
                   "\tACGT\t*\n")
    code = tassess.main([str(tmp_path / "missing.sam"), str(sam),
                         "--no-output_plot"])
    assert code == 1
    assert "No sequences mapped" in capsys.readouterr().out
    assert not (tmp_path / "empty.samacc").exists()
    with open(tmp_path / "empty.summary") as fh:
        assert fh.read() == tassess.INVALID_SUMM.format(str(sam))
