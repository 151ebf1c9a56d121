"""Training-data preparation in the port against the JAX package on the
CPU: SignalMapping's construction from a remapping path, fasta and
SAM/BAM reading, the remapping funcs (per-read and batched), and the
three CLIs as pairs (`bin/prepare_mapped_reads.py --device cpu` against
`python -m taiyaki_tpu_torch.cli.prepare_mapped_reads --device cpu`,
get_refs_from_sam and generate_per_read_params, byte for byte).  The
prepare pairs run once per pytest run (`shared_run`)."""

import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_cli import (REMAP_MODEL, one_torch_thread,  # noqa: F401
                            shared_run, subprocess_env, write_reads,
                            write_real_read)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INGREDIENTS = os.path.join(REPO, "RESULTS", "training_ingredients")
READ_PARAMS = os.path.join(INGREDIENTS, "readparams.tsv")
CHANNEL = {"offset": 4.0, "range": 1400.0, "digitisation": 8192.0,
           "sampling_rate": 4000.0}


# -- SignalMapping -----------------------------------------------------------

def _path_case(stride, seed):
    """Untrimmed dacs, per-read params with trim_start > 0, and a remap
    path over the trimmed signal's blocks: unmapped (-1) head and tail
    blocks, a climb that starts past position 0 and ends before the
    reference's last base."""
    rng = np.random.default_rng(seed)
    n = 700
    dacs = rng.integers(0, 1000, n).astype(np.int16)
    params = {"trim_start": 37, "trim_end": 11, "shift": 3.0, "scale": 2.0}
    nblk = -(-(n - 48) // stride)
    reflen = max(8, nblk // 3)
    moves = rng.random(nblk + 1 - 9) < 0.3
    path = np.concatenate([np.full(4, -1), 2 + np.cumsum(moves),
                           np.full(5, -1)])
    path = np.minimum(path, reflen - 2).astype(np.int32)
    ref = rng.integers(0, 4, reflen).astype(np.int16)
    return dacs, params, path, ref


@pytest.mark.parametrize("stride", [1, 2, 4, 5])
def test_from_remapping_path_matches_jax(stride):
    from taiyaki_tpu.data import signal as jsignal
    from taiyaki_tpu.data import signal_mapping as jsm
    from taiyaki_tpu_torch.data import signal as tsignal
    from taiyaki_tpu_torch.data import signal_mapping as tsm
    dacs, params, path, ref = _path_case(stride, stride)
    got = tsm.SignalMapping.from_remapping_path(
        path, ref, stride, tsignal.Signal(dacs=dacs, channel_info=CHANNEL,
                                          read_id="r", read_params=params))
    want = jsm.SignalMapping.from_remapping_path(
        path, ref, stride, jsignal.Signal(dacs=dacs, channel_info=CHANNEL,
                                          read_id="r", read_params=params))
    assert got.Ref_to_signal[0] == -1
    assert got.Ref_to_signal[-1] == len(dacs) + 1
    a, b = got.get_read_dictionary(), want.get_read_dictionary()
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    assert got.check() == want.check() == "pass"


@pytest.mark.parametrize("stride", [1, 2, 4, 5])
def test_get_reftosignal_matches_jax(stride):
    from taiyaki_tpu.data import signal_mapping as jsm
    from taiyaki_tpu_torch.data import signal_mapping as tsm
    rng = np.random.default_rng(10 + stride)
    siglen, reflen = 300, 60
    full = np.full(siglen, -1, dtype=np.int32)
    locs = np.arange(20, siglen - 30, stride)
    full[locs] = np.minimum(3 + np.cumsum(rng.random(len(locs)) < 0.4),
                            reflen - 4)
    for sig_to_ref in (full, np.full(siglen, -1, dtype=np.int32)):
        got = tsm.SignalMapping.get_reftosignal(sig_to_ref, reflen, siglen)
        want = jsm.SignalMapping.get_reftosignal(sig_to_ref, reflen, siglen)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32


def test_integer_reference_and_failed_checks_match_jax():
    from taiyaki_tpu.data import signal_mapping as jsm
    from taiyaki_tpu_torch.data import signal_mapping as tsm
    for seq, alphabet in (("GATTACA", "ACGT"), ("GATTZACAY", "AYCZGT")):
        got = tsm.SignalMapping.get_integer_reference(seq, alphabet)
        np.testing.assert_array_equal(
            got, jsm.SignalMapping.get_integer_reference(seq, alphabet))
        assert got.dtype == np.int16
    for mod in (tsm, jsm):
        with pytest.raises(ValueError, match="outside alphabet"):
            mod.SignalMapping.get_integer_reference("ACGN", "ACGT")
    fields = dict(shift_frompA=1.0, scale_frompA=2.0, range=3.0, offset=4.0,
                  digitisation=5.0, read_id="r", Dacs=np.zeros(5))
    bad = [np.array([0, 3, 2]), np.array([-2, 1, 9])]
    for r2s in bad:
        got = tsm.SignalMapping(r2s, np.zeros(2), **fields)
        want = jsm.SignalMapping(r2s, np.zeros(2), **fields)
        assert got.check() == want.check() != "pass"
        with pytest.raises(tsm.TaiyakiSigMapError):
            got.get_read_dictionary()


# -- fasta, SAM and BAM ------------------------------------------------------

def test_fasta_file_to_dict_matches_jax(tmp_path, capsys):
    from taiyaki_tpu import bio as jbio
    from taiyaki_tpu_torch import bio as tbio
    fa = tmp_path / "refs.fa"
    fa.write_text(">r1 some description\nACGT\nACGG\n\n>r2\nACGNNT\n"
                  ">empty\n>r3\nacgt\n>r4\nAYCZ\n>r1\nTTTT\n")
    for kwargs in ({}, {"filter_ambig": False},
                   {"filter_ambig": False, "flatten_ambig": False},
                   {"alphabet": "ACGTYZ"}):
        got = tbio.fasta_file_to_dict(str(fa), **kwargs)
        got_err = capsys.readouterr().err
        want = jbio.fasta_file_to_dict(str(fa), **kwargs)
        assert got == want
        assert got_err == capsys.readouterr().err
    assert tbio.reverse_complement("ACGTN") == \
        jbio.reverse_complement("ACGTN") == "NACGT"


SAM_REFS = [("chr1", 500), ("chr2", 300)]
# (name, flag, reference, 0-based start, mapq, cigar, seq, tags)
SAM_RECORDS = [
    ("read_a", 0, "chr1", 10, 60, "5S40M2I10M3D20M",
     "".join("ACGT"[i % 4] for i in range(77)),
     [("NM", "i", 5), ("XS", "Z", "left")]),
    ("read_b", 16, "chr2", 100, 30, "10H50M1N5M",
     "".join("TGCA"[i % 4] for i in range(55)), [("AS", "C", 200)]),
    ("read_c", 4, None, -1, 0, "*", "ACGT", []),
    ("read_d", 256, "chr1", 200, 1, "30M", "A" * 30, []),
]


def _sam_text():
    lines = ["@HD\tVN:1.6"] + ["@SQ\tSN:{}\tLN:{}".format(*r)
                               for r in SAM_REFS]
    for name, flag, ref, pos, mapq, cigar, seq, tags in SAM_RECORDS:
        lines.append("\t".join(
            [name, str(flag), ref or "*", str(pos + 1), str(mapq), cigar,
             "*", "0", "0", seq, "*"]
            + ["{}:{}:{}".format(t, "i" if k == "C" else k, v)
               for t, k, v in tags]))
    return "\n".join(lines) + "\n"


def _bam_bytes():
    """The same records as a BAM (gzip of the binary layout of the SAM
    spec)."""
    from taiyaki_tpu.sam import parse_cigar
    ops = "MIDNSHP=X"
    codes = "=ACMGRSVTWYHKDBN"
    text = b"@HD\tVN:1.6\n"
    out = b"BAM\x01" + struct.pack("<i", len(text)) + text
    out += struct.pack("<i", len(SAM_REFS))
    for name, length in SAM_REFS:
        out += struct.pack("<i", len(name) + 1) + name.encode() + b"\0"
        out += struct.pack("<i", length)
    names = [r[0] for r in SAM_REFS]
    for name, flag, ref, pos, mapq, cigar, seq, tags in SAM_RECORDS:
        cig = parse_cigar(cigar)
        rec = struct.pack("<iiBBHHHiiii", names.index(ref) if ref else -1,
                          pos, len(name) + 1, mapq, 0, len(cig), flag,
                          len(seq), -1, -1, 0)
        rec += name.encode() + b"\0"
        rec += b"".join(struct.pack("<I", n << 4 | ops.index(op))
                        for op, n in cig)
        nib = [codes.index(b) for b in seq] + [0]
        rec += bytes(nib[i] << 4 | nib[i + 1]
                     for i in range(0, len(seq), 2))
        rec += b"\xff" * len(seq)
        for t, k, v in tags:
            rec += t.encode() + k.encode() + (
                struct.pack("<i", v) if k == "i" else
                struct.pack("<B", v) if k == "C" else v.encode() + b"\0")
        out += struct.pack("<i", len(rec)) + rec
    return gzip.compress(out)


def _alignment_fields(aln):
    return (aln.query_name, aln.flag, aln.reference_name,
            aln.reference_start, aln.cigar, aln.seq, aln.mapq, aln.tags,
            aln.is_unmapped, aln.is_reverse, aln.query_length,
            aln.query_alignment_length, aln.reference_length,
            aln.reference_end)


def test_iter_alignments_match_jax_on_sam_and_bam(tmp_path):
    from taiyaki_tpu import sam as jsam
    from taiyaki_tpu_torch import sam as tsam
    (tmp_path / "a.sam").write_text(_sam_text())
    (tmp_path / "a.bam").write_bytes(_bam_bytes())
    seen = {}
    for ext in ("sam", "bam"):
        path = str(tmp_path / ("a." + ext))
        got = [_alignment_fields(a) for a in tsam.iter_alignments(path)]
        want = [_alignment_fields(a) for a in jsam.iter_alignments(path)]
        assert got == want
        assert [g[0] for g in got] == [r[0] for r in SAM_RECORDS]
        seen[ext] = got
    # the SAM's integer tags and the BAM's typed ones read alike
    assert seen["sam"] == seen["bam"]


# -- the remapping funcs -----------------------------------------------------

def test_per_read_params_tsv_matches_jax(tmp_path, capsys):
    from taiyaki_tpu import prepare_mapping_funcs as jpmf
    from taiyaki_tpu_torch import prepare_mapping_funcs as tpmf
    tsv = tmp_path / "p.tsv"
    with open(READ_PARAMS) as fh:
        text = fh.read()
    tsv.write_text(text + "bad\t200\t50\tnot_a_number\t1.0\n")
    got = tpmf.get_per_read_params_dict_from_tsv(str(tsv))
    got_err = capsys.readouterr().err
    want = jpmf.get_per_read_params_dict_from_tsv(str(tsv))
    assert got == want and len(got) == 5
    assert got_err == capsys.readouterr().err and "bad" in got_err
    assert [r.value for r in tpmf.RemapResult] == \
        [r.value for r in jpmf.RemapResult]


@pytest.fixture(scope="module")
def small_remap(tmp_path_factory):
    """A seeded size-16 mGru remap-shaped model (stride 4, Reverse
    layers) written by the JAX package, synthetic reads of 3 padded
    lengths (9 of one), their params and references: (fast5, read ids,
    params dict, references, checkpoint)."""
    from taiyaki_tpu.models import mGru_flipflop
    from taiyaki_tpu.utils import helpers as jhelpers
    d = tmp_path_factory.mktemp("small_remap")
    kwargs = dict(insize=1, size=16, winlen=19, stride=4)
    net = mGru_flipflop.network(**kwargs)
    with open(mGru_flipflop.__file__) as fh:
        source = fh.read()
    model = jhelpers.save_model(
        str(d), net, net.init(np.random.default_rng(3)), source, kwargs,
        {"reverse": False, "standardize": True, "version": 3})
    lengths = [1500, 2300, 1800, 1900, 4200, 1700, 1600, 2000, 1650, 1990,
               1750, 2500]
    fast5 = str(d / "reads.fast5")
    ids = write_reads(fast5, lengths, seed=4)
    rng = np.random.default_rng(5)
    params = {rid: {"trim_start": 20, "trim_end": 10, "shift": 500.0,
                    "scale": 60.0} for rid in ids}
    refs = {rid: "".join(rng.choice(list("ACGT"), n // 10))
            for rid, n in zip(ids, lengths)}
    return fast5, ids, params, refs, model


def test_remap_funcs_match_jax_and_batches_keep_the_order(small_remap):
    """oneread_remap equals the JAX package's read for read; the batched
    path (device cpu, batches of 8 of one padded length) maps as the
    per-read one (the near-tie rule, here exact) and yields in its stream
    order: a pool flushes at 8 reads, the rest by padded length, a read
    that fails at once in place."""
    from taiyaki_tpu import alphabet as jalphabet
    from taiyaki_tpu import prepare_mapping_funcs as jpmf
    from taiyaki_tpu.utils import helpers as jhelpers
    from taiyaki_tpu_torch import alphabet as talphabet
    from taiyaki_tpu_torch import prepare_mapping_funcs as tpmf
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers as thelpers
    fast5, ids, params, refs, model = small_remap
    tnet, tparams, *_ = thelpers.load_model(model)
    tnet = load_jax_params(tnet, tparams).eval()
    jnet, jparams, *_ = jhelpers.load_model(model)
    tai = talphabet.AlphabetInfo("ACGT", "ACGT")
    jai = jalphabet.AlphabetInfo("ACGT", "ACGT")
    jobs = [(fast5, rid, refs[rid]) for rid in ids]
    jobs.insert(3, (fast5, "missing", None))
    per_read = [tpmf.oneread_remap(j, tnet, params, tai, None)
                for j in jobs]
    jax_read = [jpmf.oneread_remap(j, jnet, jparams, params, jai, None)
                for j in jobs]
    for (a, ra), (b, rb) in zip(per_read, jax_read):
        assert ra.value == rb.value
        if b is not None:
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    batched = list(tpmf.batched_remap_results(
        iter(jobs), tnet, params, tai, None, io_threads=2))
    lens = {rid: len(tpmf.stage_read(j, params, None)[0]["current"])
            for j in jobs for rid in [j[1]] if j[2] is not None}
    pools, order = {}, []
    for j in jobs:
        if j[2] is None:
            order.append(None)
            continue
        pool = pools.setdefault(tpmf.padded_length(lens[j[1]]), [])
        pool.append(j[1])
        if len(pool) == 8:
            order += pools.pop(tpmf.padded_length(lens[j[1]]))
    for key in sorted(pools):
        order += pools[key]
    assert [r["read_id"] if r else None for r, _ in batched] == order
    assert len(set(tpmf.padded_length(n) for n in lens.values())) == 3
    by_id = {r["read_id"]: r for r, _ in per_read if r}
    for r, res in batched:
        if r is None:
            assert res is tpmf.RemapResult.NO_REF_FOUND
            continue
        moved = np.abs(r["Ref_to_signal"] - by_id[r["read_id"]]
                       ["Ref_to_signal"])
        assert (moved > 0).mean() < 0.01 and moved.max() <= 32


class _Broken(torch.nn.Module):
    stride = 4

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        raise RuntimeError("forward failed")


def test_network_errors_are_tallied_on_the_cpu_only(small_remap):
    """A failed forward is NETWORK_ERROR for each read of its batch for a
    network on the CPU, as in the JAX package; for one elsewhere (here on
    the meta device, which stands for a card) the error propagates."""
    from taiyaki_tpu_torch import alphabet as talphabet
    from taiyaki_tpu_torch import prepare_mapping_funcs as tpmf
    fast5, ids, params, refs, _ = small_remap
    ai = talphabet.AlphabetInfo("ACGT", "ACGT")
    jobs = [(fast5, rid, refs[rid]) for rid in ids[:3]]
    got = list(tpmf.batched_remap_results(iter(jobs), _Broken(), params, ai,
                                          None))
    assert got == [(None, tpmf.RemapResult.NETWORK_ERROR)] * 3
    assert tpmf.oneread_remap(jobs[0], _Broken(), params, ai, None) == \
        (None, tpmf.RemapResult.NETWORK_ERROR)
    with pytest.raises(RuntimeError, match="forward failed"):
        list(tpmf.batched_remap_results(iter(jobs), _Broken().to("meta"),
                                        params, ai, None))


def test_iterators_match_jax():
    from taiyaki_tpu import iterators as jit
    from taiyaki_tpu_torch import iterators as tit
    # in-process only: a fork of this JAX-loaded process may deadlock
    assert list(tit.imap_mp(pow, range(7), fix_args=(2,))) == \
        list(jit.imap_mp(pow, range(7), fix_args=(2,)))
    empty, it = tit.empty_iterator(iter([1, 2]))
    assert not empty and list(it) == [1, 2]
    assert tit.empty_iterator(iter([]))[0]
    assert tit.try_except_pass(int, "x") is None


# -- the CLI pairs -----------------------------------------------------------

def _cli(module, script, args, one_jax_device=False):
    """bin/<script> and `python -m taiyaki_tpu_torch.cli.<module>` with
    `args` (a function of the tag): {tag: CompletedProcess}."""
    out = {}
    for tag, cmd in (("jax", [os.path.join(REPO, "bin", script)]),
                     ("port", ["-m", "taiyaki_tpu_torch.cli." + module])):
        r = subprocess.run(
            [sys.executable] + cmd + args(tag), cwd=REPO,
            env=subprocess_env(one_jax_device=one_jax_device),
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        out[tag] = r
    return out


def _mapped(path):
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    with jmsf.MappedSignalReader(path) as msr:
        return ({r.read_id: r.get_read_dictionary() for r in msr.reads()},
                msr.check(), type(msr).__name__)


def _tallies(stderr):
    return [line for line in stderr.splitlines() if line.startswith("* ")]


def _prepare_pairs(d):
    """The shortest real read with its reference and readparams.tsv's
    row, a read with no reference and one with no params: both CLIs on the
    CPU, per-read layout; then the same read against its modref reference
    with --mod and --alphabet, batch layout."""
    import h5py
    reads = d / "reads"
    reads.mkdir()
    rid, ref = write_real_read(reads)
    with h5py.File(str(reads / "real.fast5"), "r") as f, \
            h5py.File(str(reads / "more.fast5"), "w") as g:
        for other in ("noref", "noparams"):
            f.copy("read_" + rid, g, name="read_" + other)
            g["read_" + other + "/Raw"].attrs["read_id"] = other
    with h5py.File(os.path.join(INGREDIENTS, "mapped_remap_modref.hdf5"),
                   "r") as f:
        modref = "".join(f.attrs["alphabet"][i]
                         for i in f["Reads"][rid]["Reference"][()])
    with open(READ_PARAMS) as fh:
        rows = fh.read().splitlines()
    params = d / "params.tsv"
    params.write_text("\n".join(
        rows + [rows[[r.split("\t")[0] for r in rows].index(rid)].replace(
            rid, "noref")]) + "\n")
    (d / "refs.fa").write_text(">{0}\n{1}\n>noparams\n{1}\n".format(rid,
                                                                   ref))
    (d / "modrefs.fa").write_text(">{}\n{}\n".format(rid, modref))
    out = {}
    for case, extra, fa in (
            ("samref", [], "refs.fa"),
            ("modref", ["--mod", "Y", "A", "6mA", "--mod", "Z", "C", "5mC",
                        "--alphabet", "ACGT", "--batch_format"],
             "modrefs.fa")):
        runs = _cli("prepare_mapped_reads", "prepare_mapped_reads.py",
                    lambda tag: ["--device", "cpu", "--jobs", "1"] + extra
                    + [str(reads), str(params),
                       str(d / "{}_{}.hdf5".format(case, tag)), REMAP_MODEL,
                       str(d / fa)], one_jax_device=True)
        out[case] = {tag: (r.stdout, _tallies(r.stderr), _mapped(str(
            d / "{}_{}.hdf5".format(case, tag)))) for tag, r in runs.items()}
    return rid, out


@pytest.fixture(scope="module")
def prepare_pairs(tmp_path_factory):
    return shared_run(tmp_path_factory, "prepare_pairs", _prepare_pairs)


@pytest.mark.parametrize("case", ["samref", "modref"])
def test_prepare_mapped_reads_matches_jax_on_the_cpu(prepare_pairs, case):
    """The same mappings (every field, Ref_to_signal exactly), the same
    stdout and the same stderr tallies, NO_REF_FOUND and NO_PARAMS
    included; the file passes check() in the JAX reader."""
    rid, out = prepare_pairs
    jax, port = out[case]["jax"], out[case]["port"]
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    want = ["* 1 reads mapped successfully"]
    if case == "samref":
        want += ["* 1 reads failed to produce remapping results due to: "
                 "No fasta reference found.",
                 "* 1 reads failed to produce remapping results due to: "
                 "No per-read params provided."]
    else:
        want += ["* 2 reads failed to produce remapping results due to: "
                 "No fasta reference found."]
    assert sorted(port[1]) == sorted(want)
    (got, verdict, layout), (expect, jverdict, jlayout) = port[2], jax[2]
    assert verdict == jverdict == "pass" and layout == jlayout
    assert list(got) == list(expect) == [rid]
    for k in expect[rid]:
        np.testing.assert_array_equal(got[rid][k], expect[rid][k])


def test_get_refs_from_sam_matches_jax(tmp_path):
    """A synthetic genome and SAM and BAM (flags 0, 16, 4, 256; clipped,
    spliced, indels) with the CLI's options: the fastas and stderr are
    byte for byte the JAX CLI's."""
    rng = np.random.default_rng(7)
    genome = tmp_path / "genome.fa"
    genome.write_text("".join(">{} chromosome\n{}\n".format(
        name, "".join(rng.choice(list("ACGTacgtN"), n)))
        for name, n in SAM_REFS))
    (tmp_path / "a.sam").write_text(_sam_text())
    (tmp_path / "a.bam").write_bytes(_bam_bytes())
    strands = tmp_path / "strands.tsv"
    strands.write_text("read_id\nread_b\nread_d\n")
    inputs = [str(genome), str(tmp_path / "a.sam"), str(tmp_path / "a.bam")]
    for i, opts in enumerate(([], ["--pad", "5", "--min_coverage", "0.5"],
                              ["--reverse", "--complement", "--pad", "200"],
                              ["--input_strand_list", str(strands)])):
        runs = _cli("get_refs_from_sam", "get_refs_from_sam.py",
                    lambda tag: opts + ["--output", str(
                        tmp_path / "{}_{}.fa".format(tag, i))] + inputs)
        texts = [(tmp_path / "{}_{}.fa".format(tag, i)).read_text()
                 for tag in ("jax", "port")]
        assert texts[0] == texts[1]
        assert runs["jax"].stderr == runs["port"].stderr
        assert texts[0].count(">read_b") == 2 and ">read_c" not in texts[0]


def test_generate_per_read_params_matches_jax(tmp_path):
    reads = tmp_path / "reads"
    reads.mkdir()
    write_reads(str(reads / "a.fast5"), [3000, 500, 12000], seed=8)
    for i, opts in enumerate(([], ["--trim", "100", "20"])):
        _cli("generate_per_read_params", "generate_per_read_params.py",
             lambda tag: opts + ["--output", str(
                 tmp_path / "{}_{}.tsv".format(tag, i)), str(reads)])
        texts = [(tmp_path / "{}_{}.tsv".format(tag, i)).read_text()
                 for tag in ("jax", "port")]
        assert texts[0] == texts[1] and texts[0].count("\n") == 4


def test_prepare_default_device_is_cuda(small_remap, tmp_path):
    """With no --device the CLI asks for the card; without one it exits
    non-zero naming CUDA and writes nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fast5, _, _, _, model = small_remap
    out = tmp_path / "mapped.hdf5"
    (tmp_path / "refs.fa").write_text(">x\nACGT\n")
    r = subprocess.run(
        [sys.executable, "-m", "taiyaki_tpu_torch.cli.prepare_mapped_reads",
         os.path.dirname(fast5), READ_PARAMS, str(out), model,
         str(tmp_path / "refs.fa")], cwd=REPO, env=subprocess_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not out.exists()
