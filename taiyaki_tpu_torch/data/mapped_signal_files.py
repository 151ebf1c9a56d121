"""Mapped-signal files (HDF5, format version 8), reader side (port of
taiyaki_tpu/data/mapped_signal_files.py).

Reads both layouts the JAX package writes: per-read (/Reads/<read_id>,
one dataset per array field and one attribute per scalar field) and batch
(/Batches/Batch_N, per-field concatenated arrays with <field>_lengths).
Files open through h5py where it is installed and through the port's own
reader (data.hdf5) elsewhere, as fast5 files do.
"""

import numpy as np

from taiyaki_tpu_torch.alphabet import AlphabetInfo
from taiyaki_tpu_torch.data.hdf5 import open_file
from taiyaki_tpu_torch.data.signal_mapping import (
    OPTIONAL_FIELDS, REQUIRED_FIELDS, SignalMapping)

_version = 8
READS_ROOT = "Reads"
BATCH_ROOT = "Batches"
LENGTH_SUFFIX = "_lengths"


def _dec(v):
    return v.decode() if isinstance(v, bytes) else v


def _field_dtype(name):
    return REQUIRED_FIELDS.get(name, OPTIONAL_FIELDS.get(name))


def _is_array_field(name):
    dt = _field_dtype(name)
    return not isinstance(dt, type) or issubclass(dt, np.generic)


class MappedSignalReader:
    """Reader of a mapped-signal file of either layout."""

    def __init__(self, filename):
        self.hdf5 = open_file(filename)
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
