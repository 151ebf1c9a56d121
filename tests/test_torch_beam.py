"""`python -m taiyaki_tpu_torch.cli.basecall --beam 5 1` against
`bin/basecall.py --beam 5 1` on the CPU: byte-equal fasta and fastq on
synthetic reads with a size-16 mLstm checkpoint, and on the shortest real
read with the shipped mGru remap checkpoint (whose beam call is as close
to the read's reference as the Viterbi call).  Each pair runs once per
pytest run (`shared_run`)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import (REMAP_MODEL, _chip_smoke, shared_run,
                            subprocess_env, write_reads, write_real_read)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAM = ["--beam", "5", "1"]


def _calls(text, fastq):
    """A fasta's or fastq's records: {read id: (sequence, quality or
    None)}."""
    lines = text.splitlines()
    step = 4 if fastq else 2
    return {lines[i][1:]: (lines[i + 1], lines[i + 3] if fastq else None)
            for i in range(0, len(lines), step)}


def _run_pairs(d, reads, model, extra):
    """Both CLIs on `reads` with `model`, --beam 5 1 and `extra`, fasta
    and fastq: {(cli, "fa" or "fq"): file text}."""
    out = {}
    for tag, cmd in (
            ("jax", [os.path.join(REPO, "bin", "basecall.py"),
                     "--ndevices", "1"]),
            ("port", ["-m", "taiyaki_tpu_torch.cli.basecall"])):
        for ext, fastq in (("fa", []), ("fq", ["--fastq"])):
            path = str(d / "{}.{}".format(tag, ext))
            r = subprocess.run(
                [sys.executable] + cmd + ["--device", "cpu", "--quiet",
                                          "--output", path] + BEAM + fastq
                + extra + [str(reads), model], cwd=REPO,
                env=subprocess_env(), capture_output=True, text=True,
                timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            with open(path) as fh:
                out[tag, ext] = fh.read()
    return out


def _synthetic(d):
    """A size-16 mLstm checkpoint of seed 2 (whose beam calls hundreds of
    bases on these reads; many seeds call a few), written by the JAX
    package, and three reads: one shorter than a chunk, two of several
    chunks."""
    from taiyaki_tpu.models import mLstm_flipflop
    from taiyaki_tpu.utils import helpers as jhelpers
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    net = mLstm_flipflop.network(**kwargs)
    with open(mLstm_flipflop.__file__) as fh:
        source = fh.read()
    model = jhelpers.save_model(str(d), net,
                                net.init(np.random.default_rng(2)), source,
                                kwargs, {"reverse": False,
                                         "standardize": True, "version": 3})
    reads = d / "reads"
    reads.mkdir()
    write_reads(str(reads / "batch0.fast5"), [170, 1200, 2900])
    return _run_pairs(d, reads, model, ["--chunk_size", "60", "--overlap",
                                        "10", "--max_concurrent_chunks",
                                        "4"])


def _real(d):
    reads = d / "reads"
    reads.mkdir()
    rid, ref = write_real_read(reads)
    out = _run_pairs(d, reads, REMAP_MODEL, ["--max_concurrent_chunks",
                                             "8"])
    return out, rid, ref


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return shared_run(tmp_path_factory, "beam_synthetic", _synthetic)


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    return shared_run(tmp_path_factory, "beam_real", _real)


@pytest.mark.parametrize("ext", ["fa", "fq"])
def test_beam_synthetic_reads_match_jax(synthetic, ext):
    assert synthetic["port", ext] == synthetic["jax", ext]
    calls = _calls(synthetic["port", ext], ext == "fq")
    assert sorted(calls) == ["read00", "read01", "read02"]
    assert sum(len(seq) for seq, _ in calls.values()) > 300
    for seq, qual in calls.values():
        assert set(seq) <= set("ACGT")
        assert qual is None or len(qual) == len(seq)


@pytest.mark.parametrize("ext", ["fa", "fq"])
def test_beam_real_read_matches_jax(real, ext):
    """Byte-equal output, one q-score a base; the beam's call is as close
    to the reference as the Viterbi call (identity 0.871 against
    0.870)."""
    out, rid, ref = real
    assert out["port", ext] == out["jax", ext]
    calls = _calls(out["port", ext], ext == "fq")
    seq, qual = calls[rid]
    assert round(_chip_smoke().semiglobal_identity(seq, ref), 3) == 0.871
    if qual is not None:
        assert len(qual) == len(seq)


def test_beam_fasta_is_fastq_calls(real):
    out, rid, _ = real
    fa = _calls(out["port", "fa"], False)
    fq = _calls(out["port", "fq"], True)
    assert fa[rid][0] == fq[rid][0]
