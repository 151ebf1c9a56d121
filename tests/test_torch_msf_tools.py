"""The port's mapped-signal tools on the CPU against the JAX package's
misc/ tools, each with h5py and with it hidden from the port
(`mapped_signal_files._h5py` and `open_file` patched, as on a host
without h5py): on RESULTS/training_ingredients' mapped reads, on a v7 copy
made with h5py here, and on `synth_dataset` output.  The JAX tools run in
process on h5py; everything written is read back through h5py."""

import os
import shutil
import sys

import h5py
import numpy as np
import pytest

from test_torch_seqalign import misc_module
from taiyaki_tpu_torch.cli import (
    check_mapped_signal_file as tcheck,
    convert_alphabet_or_inspect_mapped_signal_file as tconvert,
    merge_mappedsignalfiles as tmerge, synth_dataset as tsynth,
    upgrade_mapped_signal as tupgrade)
from taiyaki_tpu_torch.data import hdf5
from taiyaki_tpu_torch.data import mapped_signal_files as tmsf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INGREDIENTS = os.path.join(REPO, "RESULTS", "training_ingredients")
SAMREF = os.path.join(INGREDIENTS, "mapped_remap_samref.hdf5")
MODREF = os.path.join(INGREDIENTS, "mapped_remap_modref.hdf5")


@pytest.fixture(params=[True, False], ids=["h5py", "no_h5py"])
def with_h5py(request, monkeypatch):
    if not request.param:
        monkeypatch.setattr(tmsf, "_h5py", lambda: None)
        monkeypatch.setattr(tmsf, "open_file", hdf5.File)
    return request.param


def run_jax(name, argv, monkeypatch, capsys):
    """misc/<name>.py's main in process on argv: (exit code, stdout,
    stderr)."""
    mod = misc_module(name)
    monkeypatch.setattr(sys, "argv", [name + ".py"] + list(argv))
    return _run(mod.main, capsys)


def run_port(main, argv, capsys):
    return _run(lambda: main(list(argv)), capsys)


def _run(fn, capsys):
    try:
        code = fn()
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return (code if isinstance(code, int) else 0 if code is None
            else code), out, err


def tree(path):
    """{object path: (attributes, dataset value or None)} of an HDF5 file,
    read with h5py (str and bytes both as str)."""
    def norm(v):
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, np.ndarray) and v.dtype.kind == "O":
            return [norm(x) for x in v.tolist()]
        return v

    out = {}

    def visit(name, obj):
        attrs = {k: norm(v) for k, v in obj.attrs.items()}
        value = norm(obj[()]) if isinstance(obj, h5py.Dataset) else None
        out[name] = (attrs, value)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        (ga, gv), (wa, wv) = got[name], want[name]
        assert sorted(ga) == sorted(wa), name
        for k in wa:
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=name + k)
        if isinstance(wv, np.ndarray):
            assert gv.dtype == wv.dtype, name
        np.testing.assert_array_equal(gv, wv, err_msg=name)


def make_v7(src, dst):
    """A version 7 copy of a v8 per-read file (h5py): the alphabet
    attributes on every read, not the root, and no mod_long_names."""
    shutil.copyfile(src, dst)
    with h5py.File(dst, "r+") as f:
        for rid in f["Reads"]:
            for k in ("alphabet", "collapse_alphabet"):
                f["Reads"][rid].attrs[k] = f.attrs[k]
        for k in ("alphabet", "collapse_alphabet", "mod_long_names"):
            del f.attrs[k]
        f.attrs["version"] = 7
    return dst


@pytest.fixture(scope="module")
def synth_jax(tmp_path_factory):
    """misc/synth_dataset.py's small set (4 + 2 reads of 300 bases)."""
    d = tmp_path_factory.mktemp("synth_jax")
    mod = misc_module("synth_dataset")
    argv = sys.argv
    sys.argv = ["synth_dataset.py", str(d), "--ntrain", "4", "--nholdout",
                "2", "--nbases", "300", "--seed", "3"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return d


def test_synth_dataset_matches_jax(synth_jax, tmp_path, with_h5py, capsys):
    tsynth.main([str(tmp_path), "--ntrain", "4", "--nholdout", "2",
                 "--nbases", "300", "--seed", "3"])
    assert "wrote" in capsys.readouterr().out
    for name in ("train.hdf5", "holdout.fast5"):
        assert_trees_equal(tree(str(tmp_path / name)),
                           tree(str(synth_jax / name)))
    with open(tmp_path / "holdout_refs.fa") as fh, \
            open(synth_jax / "holdout_refs.fa") as fj:
        assert fh.read() == fj.read()
    # the JAX package's reader reads the port's training file
    from taiyaki_tpu.data.mapped_signal_files import MappedSignalReader
    with MappedSignalReader(str(tmp_path / "train.hdf5")) as msr:
        reads = list(msr.reads())
    assert len(reads) == 4 and all(r.check() == "pass" for r in reads)


@pytest.mark.parametrize("which", ["samref", "modref", "synth", "v7"])
def test_check_matches_jax(which, synth_jax, tmp_path, with_h5py,
                           monkeypatch, capsys):
    """The same report and exit code: 0 on a passing file; on a v7 file
    both refuse it (the readers check the version first)."""
    path = {"samref": SAMREF, "modref": MODREF,
            "synth": str(synth_jax / "train.hdf5")}.get(which)
    if which == "v7":
        path = make_v7(SAMREF, str(tmp_path / "v7.hdf5"))
        with pytest.raises(ValueError, match="version"):
            tcheck.main([path])
        with pytest.raises(AssertionError):
            run_jax("check_mapped_signal_file", [path], monkeypatch, capsys)
        return
    for argv in ([path], ["--summary_limit", "2", path]):
        want = run_jax("check_mapped_signal_file", argv, monkeypatch,
                       capsys)
        got = run_port(tcheck.main, argv, capsys)
        assert got[:2] == want[:2]
        assert got[0] == 0 and "* Integrity check: pass" in got[1]


def _read_back(path):
    """(alphabet, {read id: read dictionary}) through the JAX package's
    reader (h5py)."""
    from taiyaki_tpu.data.mapped_signal_files import MappedSignalReader
    with MappedSignalReader(path) as msr:
        ai = msr.get_alphabet_information()
        reads = {r.read_id: r.get_read_dictionary() for r in msr.reads()}
        return (ai.alphabet, ai.collapse_alphabet, ai.mod_long_names), reads


def _assert_reads_equal(got, want):
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for rid, rd in want[1].items():
        assert sorted(got[1][rid]) == sorted(rd)
        for k, v in rd.items():
            np.testing.assert_array_equal(got[1][rid][k], v, err_msg=k)


@pytest.mark.parametrize("case", ["all", "limit", "mods", "batch"])
def test_merge_matches_jax(case, synth_jax, tmp_path, with_h5py,
                           monkeypatch, capsys):
    """The same reads, alphabet and labels: two files in full (the read
    count their sum), a seeded subset, a modified-base merge that re-codes
    the labels, and the batch layout."""
    synth = str(synth_jax / "train.hdf5")
    argv = {"all": ["--input", SAMREF, "None", "--input", synth, "None"],
            "limit": ["--input", SAMREF, "2", "--input", synth, "3",
                      "--seed", "5"],
            "mods": ["--input", synth, "None", "--input", MODREF, "None",
                     "--allow_mod_merge"],
            "batch": ["--input", synth, "None", "--input", SAMREF, "None",
                      "--batch_format"]}[case]
    outs = []
    for who in ("jax", "port"):
        out = str(tmp_path / (who + ".hdf5"))
        if who == "jax":
            res = run_jax("merge_mappedsignalfiles", [out] + argv,
                          monkeypatch, capsys)
        else:
            res = run_port(tmerge.main, [out] + argv, capsys)
        assert "* Wrote" in res[2]
        outs.append(_read_back(out))
    _assert_reads_equal(outs[1], outs[0])
    assert len(outs[1][1]) == {"all": 7, "limit": 5, "mods": 7,
                               "batch": 7}[case]
    if case == "mods":
        # the ACGT reads' labels re-coded into the merged alphabet
        merged = outs[1][0][0]
        assert merged == "AYCZGT"
        from taiyaki_tpu_torch.data.mapped_signal_files import \
            MappedSignalReader
        with MappedSignalReader(synth) as msr:
            for r in msr.reads():
                np.testing.assert_array_equal(
                    outs[1][1][r.read_id]["Reference"],
                    ["AYCZGT".index("ACGT"[i]) for i in r.Reference])


def test_merge_refuses_a_mismatched_alphabet(tmp_path, with_h5py, capsys):
    with pytest.raises(SystemExit, match="Alphabets do not match"):
        tmerge.main([str(tmp_path / "out.hdf5"), "--input", SAMREF, "None",
                     "--input", MODREF, "None"])


@pytest.mark.parametrize("convert", [
    ["--mod_base_convert", "Z", "W", "--mod_long_name_convert", "5mC",
     "methylC"],
    ["--can_base_convert", "C", "X"]])
def test_convert_alphabet_matches_jax(convert, tmp_path, with_h5py,
                                      monkeypatch, capsys):
    """The same file after the edit (attributes and datasets, read with
    h5py); without h5py the port rewrites the file and renames it into
    place."""
    paths = []
    for who in ("jax", "port"):
        path = str(tmp_path / (who + ".hdf5"))
        shutil.copyfile(MODREF, path)
        argv = [path] + convert
        if who == "jax":
            res = run_jax("convert_alphabet_or_inspect_mapped_signal_file",
                          argv, monkeypatch, capsys)
        else:
            res = run_port(tconvert.main, argv, capsys)
        assert res[0] == 0 and "Updated alphabet" in res[2]
        paths.append(path)
    assert_trees_equal(tree(paths[1]), tree(paths[0]))
    assert tree(paths[1])["/"][0]["alphabet"] != tree(MODREF)["/"][0][
        "alphabet"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_convert_alphabet_prints_and_refuses(tmp_path, with_h5py,
                                             monkeypatch, capsys):
    """--print_only --print_read_total: the same stderr, the file
    untouched; an unknown base: the same refusal."""
    path = str(tmp_path / "m.hdf5")
    shutil.copyfile(MODREF, path)
    before = tree(path)
    argv = [path, "--print_only", "--print_read_total"]
    want = run_jax("convert_alphabet_or_inspect_mapped_signal_file", argv,
                   monkeypatch, capsys)
    got = run_port(tconvert.main, argv, capsys)
    assert got == want and "contains 3 total reads" in got[2]
    assert_trees_equal(tree(path), before)
    with pytest.raises(SystemExit, match="not found in file"):
        tconvert.main([path, "--mod_base_convert", "Q", "W"])


def test_upgrade_matches_jax(tmp_path, with_h5py, monkeypatch, capsys):
    """v7 to v8: the same attributes and datasets as the JAX tool's
    output, which is the original v8 file's content."""
    v7 = make_v7(SAMREF, str(tmp_path / "v7.hdf5"))
    outs = []
    for who in ("jax", "port"):
        out = str(tmp_path / (who + ".hdf5"))
        if who == "jax":
            res = run_jax("upgrade_mapped_signal", [v7, out], monkeypatch,
                          capsys)
        else:
            res = run_port(tupgrade.main, [v7, out], capsys)
        assert res[0] == 0 and "Upgrading to version 8" in res[1]
        outs.append(out)
    got, want = tree(outs[1]), tree(outs[0])
    assert_trees_equal(got, want)
    assert want["/"][0]["version"] == 8
    assert_trees_equal(got, tree(SAMREF))
    # a v8 file is left as it is
    res = run_port(tupgrade.main, [SAMREF, str(tmp_path / "again.hdf5")],
                   capsys)
    assert res[0] == 0 and "Upgrading" not in res[1]
    assert_trees_equal(tree(str(tmp_path / "again.hdf5")), tree(SAMREF))
