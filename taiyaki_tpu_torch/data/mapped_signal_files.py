"""Mapped-signal files (HDF5, format version 8), reader and writers (port
of taiyaki_tpu/data/mapped_signal_files.py).

Two layouts, read and written as the JAX package does: per-read
(/Reads/<read_id>, one dataset per array field and one attribute per
scalar field, and a root dataset read_ids) and batch (/Batches/Batch_N,
per-field concatenated arrays with <field>_lengths, scalar fields as
per-read vectors).  Files open and are written through h5py where it is
installed and through the port's own HDF5 reader and writer (data.hdf5)
elsewhere, as fast5 files are: the values are the same either way, and
strings are variable-length UTF-8, which h5py reads back as str.
"""

import numpy as np

from taiyaki_tpu_torch.alphabet import AlphabetInfo
from taiyaki_tpu_torch.data import hdf5
from taiyaki_tpu_torch.data.hdf5 import open_file
from taiyaki_tpu_torch.data.signal_mapping import (
    OPTIONAL_FIELDS, REQUIRED_FIELDS, SignalMapping)

_version = 8
READS_ROOT = "Reads"
BATCH_ROOT = "Batches"
BATCH_TMPLT = "Batch_{}"
LENGTH_SUFFIX = "_lengths"


def _dec(v):
    return v.decode() if isinstance(v, bytes) else v


def _field_dtype(name):
    return REQUIRED_FIELDS.get(name, OPTIONAL_FIELDS.get(name))


def _is_array_field(name):
    dt = _field_dtype(name)
    return not isinstance(dt, type) or issubclass(dt, np.generic)


class MappedSignalReader:
    """Reader of a mapped-signal file of either layout.  With
    `load_in_mem`, h5py reads the whole file into memory first, as the JAX
    reader does; data.hdf5 maps the file either way."""

    def __init__(self, filename, load_in_mem=False):
        h5 = _h5py() if load_in_mem else None
        self.hdf5 = (open_file(filename) if h5 is None
                     else h5.File(filename, "r", driver="core"))
        try:
            version = self.hdf5.attrs["version"]
            if version != _version:
                raise ValueError("Incorrect file version, got {} expected "
                                 "{}".format(version, _version))
            self.is_batch = BATCH_ROOT in self.hdf5.keys()
            self._read_id_to_batch = {}
            if self.is_batch:
                for name in self.hdf5[BATCH_ROOT].keys():
                    ids = self.hdf5[BATCH_ROOT + "/" + name + "/read_id"][()]
                    for rid in ids:
                        self._read_id_to_batch[_dec(rid)] = name
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        self.hdf5.close()

    @property
    def version(self):
        return self.hdf5.attrs["version"]

    def get_alphabet_information(self):
        attrs = self.hdf5.attrs
        return AlphabetInfo(_dec(attrs["alphabet"]),
                            _dec(attrs["collapse_alphabet"]),
                            _dec(attrs["mod_long_names"]).splitlines())

    def get_read_ids(self):
        if self.is_batch:
            return list(self._read_id_to_batch)
        if "read_ids" in self.hdf5.keys():
            return [_dec(v) for v in self.hdf5["read_ids"][()]]
        return list(self.hdf5[READS_ROOT].keys())

    def _read_group(self, read_id):
        group = self.hdf5[READS_ROOT + "/" + read_id]
        fields = {k: group[k][()] for k in group.keys()}
        fields.update({k: _dec(v) for k, v in dict(group.attrs).items()})
        return SignalMapping(**fields)

    def _load_batch(self, name):
        group = self.hdf5[BATCH_ROOT + "/" + name]
        columns = {}
        for k in group.keys():
            if k.endswith(LENGTH_SUFFIX):
                continue
            data = group[k][()]
            if _is_array_field(k):
                splits = np.cumsum(group[k + LENGTH_SUFFIX][()][:-1])
                columns[k] = np.split(data, splits)
            else:
                columns[k] = [_dec(v) if _field_dtype(k) is str else v
                              for v in data]
        out = {}
        for row in zip(*columns.values()):
            fields = dict(zip(columns.keys(), row))
            out[fields["read_id"]] = SignalMapping(**fields)
        return out

    def __iter__(self):
        if self.is_batch:
            for name in self.hdf5[BATCH_ROOT].keys():
                yield from self._load_batch(name).values()
        else:
            for read_id in self.hdf5[READS_ROOT].keys():
                yield self._read_group(read_id)

    def reads(self, read_ids=None):
        """SignalMapping of every read, or of those in `read_ids` (in
        sorted order, as the JAX package gives them)."""
        if read_ids is None:
            yield from iter(self)
            return
        wanted = sorted(set(read_ids).intersection(self.get_read_ids()))
        if not self.is_batch:
            for read_id in wanted:
                yield self._read_group(read_id)
            return
        by_batch = {}
        for rid in wanted:
            by_batch.setdefault(self._read_id_to_batch[rid], []).append(rid)
        for name, rids in by_batch.items():
            batch = self._load_batch(name)
            for rid in rids:
                yield batch[rid]

    def check(self, limit_report_lines=100):
        """Check every read in the file; 'pass' or a report string."""
        report = []
        if "version" not in self.hdf5.attrs:
            report.append("Can't get version number")
        elif self.hdf5.attrs["version"] != _version:
            report.append("Version number of file is {} and should be {}"
                          .format(self.hdf5.attrs["version"], _version))
        nreads = 0
        for read in self:
            nreads += 1
            if sum(r.count("\n") + 1 for r in report) >= limit_report_lines:
                report.append("Number of lines in error report limited")
                break
            verdict = read.check()
            if verdict != SignalMapping.pass_str:
                report.append("Read " + read.read_id + ":\n" + verdict)
        if nreads == 0:
            report.append("No reads in file")
        if not report:
            return SignalMapping.pass_str
        return "\n".join(report) + "\n"


def _h5py():
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def edit_in_place(filename, edit):
    """edit(root) on an HDF5 file opened for writing, and its result: the
    file opened "r+" by h5py where it is installed; else the whole file
    read into memory, edited there and written anew beside it through
    hdf5.Writer, then renamed into place (`hdf5.rewrite`).  `edit` sees a
    group either way (iteration over
    member names, `root[path]`, `attrs` set, read and deleted); the values
    of datasets and attributes come out the same, the bytes not."""
    h5 = _h5py()
    if h5 is None:
        return hdf5.rewrite(filename, edit)
    with h5.File(filename, "r+") as root:
        return edit(root)


class _WriterBase:
    """A new file through h5py (with `h5py_kwargs`) where it is installed,
    else through data.hdf5.Writer."""

    def __init__(self, filename, alphabet_info, **h5py_kwargs):
        self._h5 = _h5py()
        self.hdf5 = (hdf5.Writer(filename) if self._h5 is None
                     else self._h5.File(filename, "w", **h5py_kwargs))
        self.hdf5.attrs["version"] = _version
        self.hdf5.attrs["alphabet"] = alphabet_info.alphabet
        self.hdf5.attrs["collapse_alphabet"] = alphabet_info.collapse_alphabet
        self.hdf5.attrs["mod_long_names"] = "\n".join(
            alphabet_info.mod_long_names)
        self.read_ids = []

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def _dataset(self, group, name, data):
        """Through h5py as the JAX package writes it: gzip, shuffle for
        numbers, str as variable-length UTF-8.  Through data.hdf5.Writer:
        the same values, contiguous and unfiltered."""
        if self._h5 is None:
            return group.create_dataset(name, data=data)
        if data.dtype.kind in "UO":
            vlen = self._h5.special_dtype(vlen=str)
            ds = group.create_dataset(name, data.shape, dtype=vlen,
                                      compression="gzip")
            ds[...] = data
            return ds
        return group.create_dataset(name, data=data, compression="gzip",
                                    shuffle=True)

    def _write_read_ids_index(self):
        if self.read_ids:
            self._dataset(self.hdf5, "read_ids",
                          np.array(self.read_ids, dtype=object))


class PerReadHDF5Writer(_WriterBase):
    """Writer for the per-read layout."""

    def __init__(self, filename, alphabet_info):
        super().__init__(filename, alphabet_info, libver="v108",
                         track_order=True)

    def write_read(self, readdict):
        read_id = readdict["read_id"]
        self.read_ids.append(read_id)
        g = self.hdf5.create_group(READS_ROOT + "/" + read_id)
        for k, v in readdict.items():
            if isinstance(v, np.ndarray):
                self._dataset(g, k, v)
            else:
                g.attrs[k] = v

    def close(self):
        self._write_read_ids_index()
        self.hdf5.close()


class BatchHDF5Writer(_WriterBase):
    """Writer for the batched layout (default batch_size 25000 reads):
    host memory holds at most one batch of reads."""

    def __init__(self, filename, alphabet_info, batch_size=25000):
        super().__init__(filename, alphabet_info)
        self.batch_size = batch_size
        self._pending = []
        self._batch_idx = 0

    def write_read(self, readdict):
        self.read_ids.append(readdict["read_id"])
        self._pending.append(readdict)
        if len(self._pending) >= self.batch_size:
            self._flush_batch()

    def _flush_batch(self):
        g = self.hdf5.create_group(
            BATCH_ROOT + "/" + BATCH_TMPLT.format(self._batch_idx))
        keys = sorted(set(k for rd in self._pending for k in rd.keys()))
        for k in keys:
            dtype = _field_dtype(k)
            if _is_array_field(k):
                lengths = np.zeros(len(self._pending), dtype=np.int32)
                vals = []
                for i, rd in enumerate(self._pending):
                    if k in rd:
                        vals.append(rd[k])
                        lengths[i] = len(rd[k])
                self._dataset(g, k, np.concatenate(vals).astype(dtype))
                self._dataset(g, k + LENGTH_SUFFIX, lengths)
            elif dtype is str:
                self._dataset(g, k, np.array(
                    [rd.get(k, "") for rd in self._pending], dtype=object))
            else:
                # A missing optional scalar is stored as 0: the batch
                # layout has no absence encoding, and the JAX package
                # writes the same
                self._dataset(g, k, np.array(
                    [rd.get(k, 0) for rd in self._pending], dtype=dtype))
        self._pending = []
        self._batch_idx += 1

    def close(self):
        self._write_read_ids_index()
        if self._pending:
            self._flush_batch()
        self.hdf5.close()


def HDF5Writer(filename, alphabet_info, batch_format=True):
    """Create a mapped-signal file in the batch (default) or per-read
    layout."""
    if batch_format:
        return BatchHDF5Writer(filename, alphabet_info)
    return PerReadHDF5Writer(filename, alphabet_info)


MappedSignalWriter = HDF5Writer
