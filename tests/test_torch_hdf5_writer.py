"""The port's HDF5 writer (data.hdf5.Writer) and mapped-signal writers
(data.mapped_signal_files) against h5py and the JAX package's reader:
str as variable-length UTF-8, symbol-table groups of any size, dataset
bytes in the file when the dataset is created."""

import os

import h5py
import numpy as np
import pytest

from taiyaki_tpu_torch.data import hdf5
from taiyaki_tpu_torch.data import mapped_signal_files as tmsf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODREF = os.path.join(REPO, "RESULTS", "training_ingredients",
                      "mapped_remap_modref.hdf5")


def _port_alphabet(ai):
    from taiyaki_tpu_torch.alphabet import AlphabetInfo
    return AlphabetInfo(ai.alphabet, ai.collapse_alphabet,
                        ai.mod_long_names)


def _read_dicts():
    """The modref reads as the writers take them, one with the optional
    fields and one with a mapping score only (the batch layout stores the
    missing method as "" and the missing score as 0)."""
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    with jmsf.MappedSignalReader(MODREF) as msr:
        reads = [r.get_read_dictionary() for r in msr.reads()]
        ai = msr.get_alphabet_information()
    reads[0].update(mapping_score=12.5, mapping_method="remap ü")
    reads[1]["mapping_score"] = -3.25
    return reads, ai


def _same_read(got, want, batch_format):
    for k, v in want.items():
        g = getattr(got, k)
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v)
        else:
            assert type(g) is type(v) and g == v, k
    if batch_format:
        assert got.mapping_score == want.get("mapping_score", 0.0)
        assert got.mapping_method == want.get("mapping_method", "")
    else:
        assert got.mapping_score == want.get("mapping_score")
        assert got.mapping_method == want.get("mapping_method")


@pytest.mark.parametrize("batch_format", [False, True])
@pytest.mark.parametrize("with_h5py", [True, False])
def test_mapped_signal_writer_reads_back_in_both_packages(
        tmp_path, monkeypatch, batch_format, with_h5py):
    """Both layouts, written through h5py and through hdf5.Writer (h5py
    hidden, as on a machine without it): the JAX reader (h5py) and the
    port's reader give every field as written, read ids, alphabets and
    string fields as str, and check() passes; the JAX writer's file of
    the same reads reads the same."""
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    reads, ai = _read_dicts()
    if not with_h5py:
        monkeypatch.setattr(tmsf, "_h5py", lambda: None)
        monkeypatch.setattr(tmsf, "open_file", hdf5.File)
    path = str(tmp_path / "port.hdf5")
    with tmsf.MappedSignalWriter(path, _port_alphabet(ai),
                                 batch_format) as w:
        for rd in reads:
            w.write_read(rd)
    jpath = str(tmp_path / "jax.hdf5")
    with jmsf.MappedSignalWriter(jpath, ai, batch_format) as w:
        for rd in reads:
            w.write_read(rd)
    want = {rd["read_id"]: rd for rd in reads}
    for reader in (jmsf.MappedSignalReader, tmsf.MappedSignalReader):
        for p in (path, jpath):
            with reader(p) as msr:
                assert msr.check() == "pass"
                assert sorted(msr.get_read_ids()) == sorted(want)
                got_ai = msr.get_alphabet_information()
                assert (got_ai.alphabet, got_ai.collapse_alphabet,
                        got_ai.mod_long_names) == (
                    ai.alphabet, ai.collapse_alphabet, ai.mod_long_names)
                for attr in ("alphabet", "collapse_alphabet",
                             "mod_long_names"):
                    assert type(msr.hdf5.attrs[attr]) is str
                got = list(msr.reads())
                assert sorted(r.read_id for r in got) == sorted(want)
                for r in got:
                    assert type(r.read_id) is str
                    _same_read(r, want[r.read_id], batch_format)
    with h5py.File(path, "r") as f:
        assert [v.decode() for v in f["read_ids"][()]] == list(want)


def test_per_read_layout_holds_more_than_65535_reads(tmp_path,
                                                     monkeypatch):
    """65 537 reads under /Reads (a group past the 16-bit message count
    of one object header) through hdf5.Writer: h5py and the JAX reader
    see every one, the port's reader too."""
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    from taiyaki_tpu_torch.alphabet import AlphabetInfo
    monkeypatch.setattr(tmsf, "_h5py", lambda: None)
    monkeypatch.setattr(tmsf, "open_file", hdf5.File)
    path = str(tmp_path / "many.hdf5")
    n = 65537
    with tmsf.MappedSignalWriter(path, AlphabetInfo("ACGT", "ACGT"),
                                 False) as w:
        for i in range(n):
            w.write_read({
                "read_id": "r{:06d}".format(i), "shift_frompA": 1.0,
                "scale_frompA": 2.0, "range": 3.0, "offset": 4.0,
                "digitisation": 5.0,
                "Dacs": np.array([i % 1000, 7], np.int16),
                "Ref_to_signal": np.array([0, 2], np.int32),
                "Reference": np.array([i % 4], np.int16)})
    names = ["r{:06d}".format(i) for i in range(n)]
    with h5py.File(path, "r") as f:
        assert list(f["Reads"]) == names
        np.testing.assert_array_equal(f["Reads/r065536/Dacs"][()],
                                      [536, 7])
    with jmsf.MappedSignalReader(path) as msr:
        assert msr.get_read_ids() == names
        r = msr.get_read("r040001")
        assert r.read_id == "r040001" and r.Reference.tolist() == [1]
    with tmsf.MappedSignalReader(path) as msr:
        assert msr.hdf5["Reads"].keys() == names
        assert next(msr.reads(["r065535"])).Dacs.tolist() == [535, 7]


def test_writer_strings_are_variable_length_utf8(tmp_path):
    """str attributes and datasets (scalar, empty, non-ASCII, arrays) come
    back from h5py as str; bytes stay fixed-length; more strings than one
    global heap collection holds."""
    path = str(tmp_path / "s.h5")
    many = ["read_{}_{}".format(i, "x" * (i % 50)) for i in range(5000)]
    with hdf5.Writer(path) as w:
        w.attrs["alphabet"] = "ACGT"
        w.attrs["mod_long_names"] = ""
        w.attrs["name"] = "5mC ü"
        w.attrs["fixed"] = b"id3"
        w.create_dataset("read_ids", data=np.array(many, dtype=object))
        w.create_dataset("long", data=np.array(["y" * 100000]))
        w.create_group("g").attrs["ids"] = np.array(["a", "bc"])
    with h5py.File(path, "r") as f:
        assert f.attrs["alphabet"] == "ACGT"
        assert f.attrs["mod_long_names"] == ""
        assert f.attrs["name"] == "5mC ü"
        assert f.attrs["fixed"] == b"id3"
        assert list(f["read_ids"].asstr()[()]) == many
        assert f["long"].asstr()[0] == "y" * 100000
        assert list(f["g"].attrs["ids"]) == ["a", "bc"]
    with hdf5.File(path) as ours:
        assert dict(ours.attrs)["name"] == "5mC ü"
        assert list(ours["read_ids"][()]) == many


def test_writer_puts_dataset_bytes_in_the_file_when_created(tmp_path):
    """A dataset's bytes are in the file before close(), and the writer
    keeps no array: memory stays bounded by what is being written."""
    path = str(tmp_path / "d.h5")
    data = np.arange(100000, dtype=np.int16)
    w = hdf5.Writer(path)
    ds = w.create_group("Reads").create_dataset("Dacs", data=data)
    w._fh.flush()
    assert os.path.getsize(path) >= data.nbytes
    assert not any(isinstance(v, np.ndarray) for v in vars(ds).values())
    w.close()
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["Reads/Dacs"][()], data)
