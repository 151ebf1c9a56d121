"""The port's own HDF5 reader and writer (data.hdf5) against h5py, and
fast5 and mapped-signal reading through it; a checkpoint written by the
port loads in the JAX package."""

import h5py
import numpy as np
import pytest
import torch

from taiyaki_tpu_torch.data import fast5utils, hdf5


def _h5py_fast5(path, n=12, libver="earliest"):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", libver=libver) as f5:
        f5.attrs["file_version"] = "2.0"
        for i in range(n):
            grp = f5.create_group("read_r{:02d}".format(i))
            ch = grp.create_group("channel_id")
            for k, v in (("digitisation", 8192.0), ("offset", 10.0),
                         ("range", 1400.5), ("sampling_rate", 4000.0)):
                ch.attrs[k] = v
            ch.attrs["channel_number"] = "123"
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = "r{:02d}".format(i)
            raw.attrs["start_time"] = np.uint64(7)
            raw.attrs["end_reason"] = True
            raw.create_dataset("Signal", data=rng.integers(
                0, 1000, 100 + i).astype("i2"))


def _same(ours, theirs):
    assert list(ours.keys()) == list(theirs.keys())
    for k in theirs.keys():
        a, b = ours[k], theirs[k]
        got, want = dict(a.attrs), dict(b.attrs)
        assert set(got) == set(want)
        for name in want:
            assert np.asarray(got[name]).tolist() == \
                np.asarray(want[name]).tolist(), name
        if isinstance(b, h5py.Dataset):
            np.testing.assert_array_equal(a[()], b[()])
            assert a[()].dtype == b.dtype
        else:
            _same(a, b)


@pytest.mark.parametrize("libver,n", [("earliest", 12), ("latest", 6)])
def test_reader_matches_h5py(tmp_path, libver, n):
    path = str(tmp_path / "a.fast5")
    _h5py_fast5(path, n=n, libver=libver)
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        _same(ours, theirs)


def test_reader_refuses_dense_link_storage(tmp_path):
    """Dense link storage, refused before the reader knew fractal heaps,
    now reads as h5py reads it; what it still refuses is named."""
    path = str(tmp_path / "dense.fast5")
    _h5py_fast5(path, n=12, libver="latest")
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert len(ours.keys()) == 12
        _same(ours, theirs)
    with h5py.File(path, "a") as f:
        f.create_dataset("grid", data=np.ones((4, 4)), chunks=(2, 2),
                         maxshape=(None, None))
    with hdf5.File(path) as ours:
        with pytest.raises(NotImplementedError, match="version 2 B-tree"):
            ours["grid"][()]


@pytest.mark.parametrize("libver,track_order", [("v108", True),
                                                ("latest", False)])
def test_reader_reads_dense_groups(tmp_path, libver, track_order):
    """40 links in one group (a fractal heap with an indirect block,
    indexed by a version 2 B-tree of more than one level), keys in
    creation order where the group tracks it."""
    path = str(tmp_path / "d.h5")
    names = ["g{:02d}".format((7 * i) % 40) for i in range(40)]
    with h5py.File(path, "w", libver=libver, track_order=track_order) as f:
        for i, n in enumerate(names):
            f.create_group(n).attrs["i"] = i
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert list(ours.keys()) == list(theirs.keys())
        assert list(ours.keys()) == (names if track_order
                                     else sorted(names))
        _same(ours, theirs)


@pytest.mark.parametrize("libver", ["v108", "latest"])
def test_reader_reads_dense_attributes(tmp_path, libver):
    path = str(tmp_path / "a.h5")
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("g")
        for i in range(30):
            g.attrs["attr{:02d}".format(i)] = np.arange(i + 1,
                                                        dtype="f4")
        g.attrs["name"] = "read_7"
        d = f.create_dataset("d", data=np.arange(5))
        for i in range(12):
            d.attrs["k{}".format(i)] = i
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        _same(ours, theirs)
        assert len(ours["g"].attrs) == 31


@pytest.mark.parametrize("batch_format", [False, True])
def test_mapped_signal_file_of_jax_writer_reads_without_h5py(
        tmp_path, monkeypatch, batch_format):
    """12 reads written by the JAX package's MappedSignalWriter (per-read
    layout: libver v108, a dense Reads group, dense read attributes; or
    the batch layout) read through the port's MappedSignalReader on its
    own HDF5 reader give what the JAX reader gives through h5py."""
    import os
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    from taiyaki_tpu_torch.data import mapped_signal_files as tmsf
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "RESULTS", "training_ingredients",
        "mapped_remap_samref.hdf5")
    with jmsf.MappedSignalReader(src) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    path = str(tmp_path / "m.hdf5")
    with jmsf.MappedSignalWriter(path, alphabet,
                                 batch_format=batch_format) as w:
        for i in range(12):
            rd = reads[i % 3].get_read_dictionary()
            rd["read_id"] = "{}_{:02d}".format(rd["read_id"], i)
            w.write_read(rd)
    with jmsf.MappedSignalReader(path) as msr:
        want = list(msr.reads())
    monkeypatch.setattr(tmsf, "open_file", hdf5.File)
    with tmsf.MappedSignalReader(path) as msr:
        assert isinstance(msr.hdf5, hdf5.File)
        got = list(msr.reads())
        assert msr.get_alphabet_information().alphabet == "ACGT"
    assert [r.read_id for r in got] == [r.read_id for r in want]
    assert len(got) == 12
    for a, b in zip(got, want):
        for k in ("Dacs", "Ref_to_signal", "Reference"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        for k in ("shift_frompA", "scale_frompA", "range", "offset",
                  "digitisation"):
            assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("index", ["single", "fixed", "extensible",
                                   "extensible_2d", "paged"])
def test_reader_reads_layout4_chunk_indexes(tmp_path, index):
    """libver="latest" chunked datasets, gzip, shuffle and fletcher32: one
    chunk (the single-chunk index), fixed dimensions (fixed array; over
    1024 chunks it is paged), one unlimited dimension (extensible array),
    and a chunk never written (zeros)."""
    path = str(tmp_path / "c.h5")
    rng = np.random.default_rng(3)
    data, kw = {
        "single": (rng.integers(0, 99, (30, 7)).astype("i4"),
                   dict(chunks=(30, 7))),
        "fixed": (rng.normal(size=(37, 11)), dict(chunks=(8, 5))),
        "extensible": (rng.integers(-9, 9, 1000).astype("i2"),
                       dict(chunks=(13,), maxshape=(None,))),
        "extensible_2d": (rng.normal(size=(50, 7)).astype("f4"),
                          dict(chunks=(3, 2), maxshape=(None, 7))),
        "paged": (rng.integers(0, 9, 3000).astype("i2"),
                  dict(chunks=(2,))),
    }[index]
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("d", data=data, compression="gzip", shuffle=True,
                         fletcher32=True, **kw)
        sparse = f.create_dataset("sparse", shape=(100,), dtype="f4",
                                  chunks=(5,), compression="gzip",
                                  **({"maxshape": (None,)}
                                     if "extensible" in index else {}))
        sparse[41:43] = [1.0, 2.0]
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        got = ours["d"][()]
        assert got.dtype == data.dtype
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(ours["sparse"][()],
                                      theirs["sparse"][()])


def test_reader_walks_large_symbol_tables(tmp_path):
    path = str(tmp_path / "big.h5")
    with h5py.File(path, "w") as f:
        for i in range(300):
            f.create_group("g{:04d}".format(i)).attrs["i"] = i
    with hdf5.File(path) as f:
        assert f.keys() == ["g{:04d}".format(i) for i in range(300)]
        assert f["g0123"].attrs["i"] == 123


@pytest.mark.parametrize("name", ["mapped_remap_samref.hdf5",
                                  "mapped_remap_modref.hdf5"])
def test_reader_reads_chunked_mapped_signal_files(name):
    """The repo's mapped reads: every dataset chunked with deflate and
    shuffle, read_ids a chunked, gzipped variable-length string dataset,
    groups in creation order."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "RESULTS", "training_ingredients", name)
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert list(ours.keys()) == list(theirs.keys())
        assert [v.decode() for v in theirs["read_ids"][()]] == \
            list(ours["read_ids"][()])
        assert dict(ours.attrs).keys() == dict(theirs.attrs).keys()
        _same(ours["Reads"], theirs["Reads"])


def test_reader_reads_chunked_nd_datasets(tmp_path):
    """2-D chunks with ragged edges, gzip and shuffle, a chunk never
    written (fill zeros), enough chunks for a B-tree of more than one
    level, fletcher32 checked (a flipped bit fails); a filter it does not
    know (lzf) is refused."""
    path = str(tmp_path / "c.h5")
    rng = np.random.default_rng(2)
    want = {
        "ints": rng.integers(-9999, 9999, (37, 23)).astype("i4"),
        "floats": rng.normal(size=(41, 5)).astype("f8"),
        "long": rng.integers(0, 100, 20000).astype("i2"),
    }
    with h5py.File(path, "w") as f:
        f.create_dataset("ints", data=want["ints"], chunks=(8, 5),
                         compression="gzip", shuffle=True)
        f.create_dataset("checked", data=want["ints"], chunks=(8, 5),
                         fletcher32=True)
        f.create_dataset("lzf", data=want["ints"], chunks=(8, 5),
                         compression="lzf")
        f.create_dataset("floats", data=want["floats"], chunks=(7, 5),
                         compression="gzip")
        f.create_dataset("long", data=want["long"], chunks=(50,),
                         shuffle=True)
        sparse = f.create_dataset("sparse", shape=(30,), dtype="f4",
                                  chunks=(10,), compression="gzip")
        sparse[12:15] = [1.0, 2.0, 3.0]
    with hdf5.File(path) as ours:
        for k, v in want.items():
            got = ours[k][()]
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)
        np.testing.assert_array_equal(
            ours["sparse"][()], np.r_[[0.0] * 12, [1, 2, 3], [0.0] * 15])
        np.testing.assert_array_equal(ours["checked"][()], want["ints"])
        with pytest.raises(NotImplementedError, match="filter 32000"):
            ours["lzf"][()]
    # a flipped bit fails the fletcher32 checksum
    with h5py.File(path, "r") as f:
        addr = f["checked"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as fh:
        fh.seek(addr)
        byte = fh.read(1)[0]
        fh.seek(addr)
        fh.write(bytes([byte ^ 1]))
    with hdf5.File(path) as ours:
        with pytest.raises(IOError, match="fletcher32"):
            ours["checked"][()]


def test_reader_follows_tracked_creation_order(tmp_path):
    path = str(tmp_path / "o.h5")
    names = ["zeta", "alpha", "mid"]
    with h5py.File(path, "w", track_order=True) as f:
        for n in names:
            f.create_group(n)
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert list(ours.keys()) == list(theirs.keys()) == names


def test_writer_output_reads_in_h5py(tmp_path):
    path = str(tmp_path / "w.fast5")
    rng = np.random.default_rng(1)
    data = {}
    with hdf5.Writer(path) as w:
        w.attrs["file_version"] = "2.0"
        for i in range(20):
            grp = w.create_group("read_{}".format(i))
            grp.create_group("channel_id").attrs["range"] = 1400.0 + i
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = "id{}".format(i)
            raw.attrs["duration"] = np.uint32(i)
            data[i] = rng.integers(-500, 500, 50 + 7 * i).astype("i2")
            raw.create_dataset("Signal", data=data[i])
        w.create_dataset("a/b/floats", data=np.linspace(0, 1, 6,
                                                        dtype="f4"))
    with h5py.File(path, "r") as f, hdf5.File(path) as ours:
        _same(ours, f)
        # a str goes out as h5py writes one: variable-length UTF-8
        assert f["read_3/Raw"].attrs["read_id"] == "id3"
        assert f["read_4/channel_id"].attrs["range"] == 1404.0
        np.testing.assert_array_equal(f["read_5/Raw/Signal"][()], data[5])
        np.testing.assert_array_equal(f["a/b/floats"][()],
                                      np.linspace(0, 1, 6, dtype="f4"))


def test_fast5_reads_through_own_reader(tmp_path, monkeypatch):
    path = str(tmp_path / "a.fast5")
    _h5py_fast5(path, n=3)
    want = {}
    with fast5utils.get_fast5_file(path) as f5:
        assert isinstance(f5.hdf5, h5py.File)
        for rid in f5.get_read_ids():
            want[rid] = f5.get_read(rid).get_raw_data()
    monkeypatch.setattr(hdf5, "open_file", hdf5.File)
    monkeypatch.setattr(fast5utils, "open_file", hdf5.File)
    with fast5utils.get_fast5_file(path) as f5:
        assert isinstance(f5.hdf5, hdf5.File)
        assert f5.get_read_ids() == list(want)
        for rid, raw in want.items():
            read = f5.get_read(rid)
            assert read.read_id == rid
            assert read.channel_info["range"] == 1400.5
            np.testing.assert_array_equal(read.get_raw_data(), raw)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """new_model + init + save_model in the port; load_model + apply in
    the JAX package gives the port's output (atol 1e-4)."""
    import jax.numpy as jnp
    from taiyaki_tpu.utils import helpers as jhelpers
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.models import mLstm_flipflop
    from taiyaki_tpu_torch.utils import helpers

    kwargs = dict(insize=1, size=8, winlen=9, stride=3)
    net, source, meta = helpers.new_model(mLstm_flipflop.__file__, **kwargs)
    assert "taiyaki_tpu_torch" not in source
    load_jax_params(net, net.init(np.random.default_rng(3)))
    ckpt = helpers.save_model(str(tmp_path), net, params_to_jax(net),
                              source, kwargs, meta)
    jnet, jparams, *_ = jhelpers.load_model(ckpt)
    x = np.random.default_rng(4).normal(size=(90, 2, 1)).astype(np.float32)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    net2, params2, src2, *_ = helpers.load_model(ckpt)
    assert src2 == source
    load_jax_params(net2, params2)
    for k, v in net.state_dict().items():
        assert torch.equal(v, net2.state_dict()[k])


class Foreign:
    """Stands for a class the port's unpickler does not admit."""


def test_checkpoint_unpickler_keeps_params_of_unknown_classes(tmp_path):
    import pickle
    import warnings
    from taiyaki_tpu_torch.utils import helpers

    ckpt = {"params": {"W": np.ones(3, np.float32)}, "x": Foreign()}
    path = str(tmp_path / "c.pkl")
    with open(path, "wb") as fh:
        pickle.dump(ckpt, fh)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = helpers._unpickle(path)
    assert any("Foreign" in str(x.message) for x in w)
    np.testing.assert_array_equal(got["params"]["W"], np.ones(3))
    assert type(got["x"]).__name__ == "Unloaded_Foreign"
