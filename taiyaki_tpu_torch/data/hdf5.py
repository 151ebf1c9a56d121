"""A small HDF5 reader and writer in pure numpy, for machines without h5py.

fast5 files are HDF5.  Where h5py is installed, `open_file` returns an
`h5py.File` and nothing here is used.  Where it is not (the port's GPU
hosts carry only PyTorch's stack), this module reads the subset of HDF5
that fast5 and mapped-signal reads need, with the h5py calls the port
makes: `keys()`, `f["a/b"]`, `dict(g.attrs)`, `dset[()]`.

Read: superblock versions 0-3, object headers versions 1 and 2 (with
continuation blocks), groups stored as a symbol table (v1 B-tree, local
heap), as compact link messages or densely (a fractal heap indexed by a
version 2 B-tree: groups of more than 8 links written with libver >=
1.8), attributes in the object header or dense likewise, of fixed-point,
float, enum, fixed-length and variable-length string types; contiguous
and compact datasets, and chunked datasets through the deflate (zlib),
shuffle and fletcher32 (checksum verified) filters: layout version 3
(chunks indexed by a v1 B-tree, the layout of mapped-signal files and of
h5py-written fast5) and layout version 4 with the single-chunk,
fixed-array and extensible-array chunk indexes (what libver="latest"
writes for datasets with at most one unlimited dimension).  The implicit and version 2 B-tree chunk indexes,
huge and tiny fractal-heap objects, other filters and shared messages
raise NotImplementedError naming themselves (install h5py for those).

Write (`Writer`): superblock 0, version-1 object headers, groups as
symbol tables (any number of children), contiguous datasets written when
they are created, and scalar or array attributes and datasets of numeric,
fixed-length string (bytes) and variable-length UTF-8 string (str) types;
h5py and libhdf5 read what it writes.

Edit (`rewrite`, for the edits h5py makes in place with "r+"): the whole
file read into memory, edited there, written anew beside it and renamed
into place; the values of its datasets and attributes are kept, not its
layout (datasets come out contiguous and unfiltered, a group's members
in name order).
"""

import functools
import mmap
import os
import struct
import zlib

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xffffffffffffffff


def open_file(filename):
    """h5py.File(filename, "r") where h5py is installed, else `File`."""
    try:
        import h5py
    except ImportError:
        return File(filename)
    return h5py.File(filename, "r")


def _u(buf, off, n):
    return int.from_bytes(buf[off:off + n], "little")


def _pad8(n):
    return (n + 7) & ~7


# -- reader ------------------------------------------------------------------

class File:
    """Read-only HDF5 file (see the module docstring for what it reads)."""

    def __init__(self, filename):
        with open(filename, "rb") as fh:
            self._buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._collections = {}
        try:
            self._root = Group(self, self._root_address(filename))
        except BaseException:
            self.close()
            raise

    def _root_address(self, filename):
        buf = self._buf
        if buf[:8] != _SIG:
            raise OSError("{} is not an HDF5 file (or its superblock is not "
                          "at offset 0)".format(filename))
        version = buf[8]
        if version in (0, 1):
            sizes, root = (buf[13], buf[14]), 24 + (4 if version == 1 else 0)
            root_addr = _u(buf, root + 32 + 8, 8)
        elif version in (2, 3):
            sizes = (buf[9], buf[10])
            root_addr = _u(buf, 36, 8)
        else:
            raise NotImplementedError("HDF5 superblock version {}".format(
                version))
        if sizes != (8, 8):
            raise NotImplementedError("HDF5 offsets/lengths of {} bytes"
                                      .format(sizes))
        return root_addr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._buf is not None:
            self._buf.close()
            self._buf = None

    def keys(self):
        return self._root.keys()

    def __getitem__(self, path):
        return self._root[path]

    @property
    def attrs(self):
        return self._root.attrs

    # -- object headers ----------------------------------------------------

    def messages(self, addr):
        """[(type, data)] of the object header at addr, continuations
        followed."""
        buf = self._buf
        out = []
        if buf[addr:addr + 4] == b"OHDR":
            flags = buf[addr + 5]
            p = addr + 6 + (16 if flags & 0x20 else 0) \
                + (4 if flags & 0x10 else 0)
            nsize = 1 << (flags & 3)
            size = _u(buf, p, nsize)
            blocks = [(p + nsize, size)]
            hdr = 6 if flags & 0x04 else 4
            while blocks:
                start, length = blocks.pop(0)
                p, end = start, start + length
                while p + hdr <= end:
                    mtype, msize, mflags = buf[p], _u(buf, p + 1, 2), buf[p + 3]
                    data = buf[p + hdr:p + hdr + msize]
                    p += hdr + msize
                    self._take(out, blocks, mtype, mflags, data, v2=True)
        elif buf[addr] == 1:
            blocks = [(addr + 16, _u(buf, addr + 8, 4))]
            while blocks:
                start, length = blocks.pop(0)
                p, end = start, start + length
                while p + 8 <= end:
                    mtype, msize, mflags = (_u(buf, p, 2), _u(buf, p + 2, 2),
                                            buf[p + 4])
                    data = buf[p + 8:p + 8 + msize]
                    p += 8 + msize
                    self._take(out, blocks, mtype, mflags, data, v2=False)
        else:
            raise NotImplementedError(
                "HDF5 object header at {} (version {})".format(addr,
                                                               buf[addr]))
        return out

    @staticmethod
    def _take(out, blocks, mtype, mflags, data, v2):
        if mtype == 0x10:       # continuation
            start, length = _u(data, 0, 8), _u(data, 8, 8)
            # a v2 continuation block has a signature and a checksum
            blocks.append((start + 4, length - 8) if v2 else (start, length))
        elif mtype != 0:
            if mflags & 0x02:
                raise NotImplementedError("shared HDF5 messages")
            out.append((mtype, data))

    # -- groups --------------------------------------------------------------

    def links(self, messages):
        """{name: object header address} of a group, in h5py's order: by
        creation order where the group tracks it, else by name."""
        links, order = {}, {}
        tracked = False
        for mtype, data in messages:
            if mtype == 0x11:           # symbol table
                heap = self._local_heap(_u(data, 8, 8))
                self._btree(_u(data, 0, 8), heap, links)
            elif mtype == 0x02:         # link info
                tracked = bool(data[1] & 1)
                p = 2 + (8 if data[1] & 1 else 0)
                heap, names = _u(data, p, 8), _u(data, p + 8, 8)
                if heap != _UNDEF:      # dense: links in a fractal heap
                    fheap = _FractalHeap(self._buf, heap)
                    for rec in _btree2_records(self._buf, names):
                        self._add_link(links, order,
                                       fheap.get(bytes(rec[4:11])))
            elif mtype == 0x06:         # link
                self._add_link(links, order, data)
        if tracked and None not in order.values():
            return dict(sorted(links.items(), key=lambda kv: order[kv[0]]))
        return dict(sorted(links.items()))

    def _add_link(self, links, order, data):
        name, addr, corder = self._link(data)
        if addr is not None:
            links[name] = addr
            order[name] = corder

    def _local_heap(self, addr):
        buf = self._buf
        _expect(buf, addr, b"HEAP")
        size, data = _u(buf, addr + 8, 8), _u(buf, addr + 24, 8)
        return buf[data:data + size]

    def _btree(self, addr, heap, links):
        buf = self._buf
        _expect(buf, addr, b"TREE")
        level, nused = buf[addr + 5], _u(buf, addr + 6, 2)
        p = addr + 24
        for i in range(nused):
            child = _u(buf, p + 16 * i + 8, 8)
            if level > 0:
                self._btree(child, heap, links)
                continue
            _expect(buf, child, b"SNOD")
            for k in range(_u(buf, child + 6, 2)):
                e = child + 8 + 40 * k
                off = _u(buf, e, 8)
                name = heap[off:heap.index(b"\0", off)].decode()
                links[name] = _u(buf, e + 8, 8)

    @staticmethod
    def _link(data):
        flags = data[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype = data[p]
            p += 1
        corder = None
        if flags & 0x04:
            corder = _u(data, p, 8)
            p += 8
        if flags & 0x10:
            p += 1
        nlen_size = 1 << (flags & 3)
        nlen = _u(data, p, nlen_size)
        p += nlen_size
        name = bytes(data[p:p + nlen]).decode()
        if ltype != 0:          # soft or external link: not followed
            return name, None, corder
        return name, _u(data, p + nlen, 8), corder

    def chunks(self, addr, ndims):
        """(offsets, filter mask, stored bytes) of every chunk under the
        v1 B-tree (type 1, raw data chunks) at addr."""
        buf = self._buf
        _expect(buf, addr, b"TREE")
        level, nused = buf[addr + 5], _u(buf, addr + 6, 2)
        keysize = 8 + 8 * ndims
        p = addr + 24
        for i in range(nused):
            key = p + i * (keysize + 8)
            child = _u(buf, key + keysize, 8)
            if level > 0:
                yield from self.chunks(child, ndims)
                continue
            size, mask = _u(buf, key, 4), _u(buf, key + 4, 4)
            offsets = tuple(_u(buf, key + 8 + 8 * d, 8)
                            for d in range(ndims - 1))
            yield offsets, mask, bytes(buf[child:child + size])

    # -- values --------------------------------------------------------------

    def decode(self, dtype_msg, space_msg, raw):
        """numpy value of raw bytes under a datatype and dataspace."""
        shape = _shape(space_msg)
        n = int(np.prod(shape)) if shape else 1
        dt = _dtype(dtype_msg)
        if dt == "vlen-str":
            vals = []
            for i in range(n):
                e = 16 * i
                length = _u(raw, e, 4)
                vals.append(self._global(_u(raw, e + 4, 8),
                                         _u(raw, e + 12, 4))[:length]
                            .decode("utf-8"))
            arr = np.array(vals, dtype=object).reshape(shape)
        else:
            arr = np.frombuffer(bytes(raw[:n * dt.itemsize]),
                                dtype=dt).reshape(shape).copy()
        return arr[()] if shape == () else arr

    def _global(self, coll, index):
        """Object `index` of the global heap collection at `coll` (each
        collection's objects found once, on its first use)."""
        objects = self._collections.get(coll)
        if objects is None:
            buf = self._buf
            _expect(buf, coll, b"GCOL")
            end = coll + _u(buf, coll + 8, 8)
            p = coll + 16
            objects = self._collections[coll] = {}
            while p + 16 <= end:
                idx, size = _u(buf, p, 2), _u(buf, p + 8, 8)
                if idx == 0:
                    break
                objects[idx] = (p + 16, size)
                p += 16 + _pad8(size)
        if index not in objects:
            raise KeyError("global heap object {} not found".format(index))
        start, size = objects[index]
        return bytes(self._buf[start:start + size])

    def attributes(self, messages):
        out = {}
        for mtype, data in messages:
            if mtype == 0x0C:
                self._add_attribute(out, data)
            elif mtype == 0x15:         # attribute info: dense storage
                p = 2 + (2 if data[1] & 1 else 0)
                heap, names = _u(data, p, 8), _u(data, p + 8, 8)
                if heap == _UNDEF:
                    continue
                fheap = _FractalHeap(self._buf, heap)
                for rec in _btree2_records(self._buf, names):
                    if rec[8] & 0x02:
                        raise NotImplementedError("shared HDF5 messages")
                    self._add_attribute(out, fheap.get(bytes(rec[:8])))
        return out

    def _add_attribute(self, out, data):
        version = data[0]
        nsz, dsz, ssz = _u(data, 2, 2), _u(data, 4, 2), _u(data, 6, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        p = 9 if version == 3 else 8
        name = bytes(data[p:p + nsz]).rstrip(b"\0").decode()
        p += pad(nsz)
        dtm = data[p:p + dsz]
        p += pad(dsz)
        spm = data[p:p + ssz]
        p += pad(ssz)
        try:
            out[name] = self.decode(dtm, spm, data[p:])
        except NotImplementedError:
            out[name] = None


def _expect(buf, addr, signature):
    if buf[addr:addr + 4] != signature:
        raise OSError("corrupt HDF5 file: no {} at {}".format(
            signature.decode(), addr))


def _log2(n):
    """floor(log2(n)) for n > 0."""
    return n.bit_length() - 1


def _enc_size(n):
    """Bytes HDF5 uses to encode counts up to n (H5VM_limit_enc_size)."""
    return _log2(n) // 8 + 1


class _FractalHeap:
    """The managed objects of a fractal heap (FRHP): `get(heap_id)` gives
    an object's bytes.  Only unfiltered heaps; huge and tiny objects (an
    object larger than the heap's largest managed size, or one stored in
    its ID) raise."""

    def __init__(self, buf, addr):
        _expect(buf, addr, b"FRHP")
        self._buf = buf
        if _u(buf, addr + 7, 2):
            raise NotImplementedError("filtered HDF5 fractal heaps")
        max_managed = _u(buf, addr + 10, 4)
        self._width = _u(buf, addr + 110, 2)
        self._start = _u(buf, addr + 112, 8)
        max_direct = _u(buf, addr + 120, 8)
        max_heap_bits = _u(buf, addr + 128, 2)
        root, rows = _u(buf, addr + 132, 8), _u(buf, addr + 140, 2)
        self._off_size = (max_heap_bits + 7) // 8
        self._len_size = min((_log2(max_direct) + 7) // 8,
                             _enc_size(max_managed))
        self._direct_rows = _log2(max_direct) - _log2(self._start) + 2
        # (heap offset, file address, size) of every direct block
        self._blocks = []
        if root == _UNDEF:
            return
        if rows == 0:
            self._blocks.append((0, root, self._start))
        else:
            self._indirect(root, rows)

    def _row_size(self, row):
        return self._start if row == 0 else self._start << (row - 1)

    def _indirect(self, addr, nrows):
        buf = self._buf
        _expect(buf, addr, b"FHIB")
        p = addr + 13 + self._off_size
        for row in range(nrows):
            size = self._row_size(row)
            for _ in range(self._width):
                child = _u(buf, p, 8)
                p += 8
                if child == _UNDEF:
                    continue
                if row < self._direct_rows:
                    _expect(buf, child, b"FHDB")
                    self._blocks.append(
                        (_u(buf, child + 13, self._off_size), child, size))
                else:
                    self._indirect(child, _log2(size) - _log2(
                        self._start * self._width) + 1)

    def get(self, heap_id):
        kind = (heap_id[0] >> 4) & 3
        if kind != 0:
            raise NotImplementedError("{} objects in HDF5 fractal heaps"
                                      .format({1: "huge", 2: "tiny"}
                                              .get(kind, "unknown")))
        off = _u(heap_id, 1, self._off_size)
        length = _u(heap_id, 1 + self._off_size, self._len_size)
        for start, addr, size in self._blocks:
            if start <= off < start + size:
                p = addr + off - start
                return self._buf[p:p + length]
        raise OSError("corrupt HDF5 file: fractal heap offset {} is in no "
                      "block".format(off))


def _btree2_records(buf, addr):
    """Every record (bytes) of the version 2 B-tree at addr, in no
    particular order."""
    _expect(buf, addr, b"BTHD")
    node_size, rec_size = _u(buf, addr + 6, 4), _u(buf, addr + 10, 2)
    depth = _u(buf, addr + 12, 2)
    root, root_nrec = _u(buf, addr + 16, 8), _u(buf, addr + 24, 2)
    # records per node and the sizes of the child pointers' counts at
    # each depth, as the library derives them (H5B2hdr.c)
    max_nrec = [(node_size - 10) // rec_size]
    cum = [max_nrec[0]]
    nrec_size = _enc_size(max_nrec[0])
    cum_size = [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - 10 - ptr) // (rec_size + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_enc_size(cum[d]))

    def walk(node, nrec, d):
        _expect(buf, node, b"BTLF" if d == 0 else b"BTIN")
        p = node + 6
        for i in range(nrec):
            yield buf[p + i * rec_size:p + (i + 1) * rec_size]
        if d == 0:
            return
        p += nrec * rec_size
        for _ in range(nrec + 1):
            child = _u(buf, p, 8)
            child_nrec = _u(buf, p + 8, nrec_size)
            p += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            yield from walk(child, child_nrec, d - 1)

    if root != _UNDEF and root_nrec:
        yield from walk(root, root_nrec, depth)


def _dtype(dt):
    cls, bits = dt[0] & 0x0f, _u(dt, 1, 3)
    size = _u(dt, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype("{}{}{}".format(order, "i" if bits & 8 else "u", size))
    if cls == 1:
        return np.dtype("{}f{}".format(order, size))
    if cls == 3:
        return np.dtype("S{}".format(size))
    if cls == 8:                        # enum: its base integer type
        return _dtype(dt[8:])
    if cls == 9 and bits & 0x0f == 1:
        return "vlen-str"
    raise NotImplementedError("HDF5 datatype class {}".format(cls))


def _filters(msg):
    """[(filter id, client data)] of a filter pipeline message, in the
    order the writer applied them."""
    if msg is None:
        return []
    version, nfilt = msg[0], msg[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(nfilt):
        fid = _u(msg, p, 2)
        named = version == 1 or fid >= 256
        nlen = _u(msg, p + 2, 2) if named else 0
        p += 4 if named else 2
        nvals = _u(msg, p + 2, 2)
        p += 4
        p += _pad8(nlen) if version == 1 else nlen
        vals = [_u(msg, p + 4 * k, 4) for k in range(nvals)]
        p += 4 * nvals
        if version == 1 and nvals % 2:
            p += 4
        out.append((fid, vals))
    return out


def _fletcher32(data):
    """libhdf5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, both sums folded to 16 bits after every 360 words, the second
    kept to 32 bits as the C code's uint32 keeps it."""
    n = len(data) // 2
    words = np.frombuffer(data[:2 * n], dtype=">u2").astype(np.uint64)
    s1 = s2 = 0
    for i in range(0, n, 360):
        c = np.cumsum(words[i:i + 360])
        s2 = (s2 + len(c) * s1 + int(c.sum())) & 0xffffffff
        s1 += int(c[-1])
        s1 = (s1 & 0xffff) + (s1 >> 16)
        s2 = (s2 & 0xffff) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xffff) + (s1 >> 16)
        s2 = (s2 & 0xffff) + (s2 >> 16)
    s1 = (s1 & 0xffff) + (s1 >> 16)
    s2 = (s2 & 0xffff) + (s2 >> 16)
    return (s2 << 16) | s1


def _unfilter(data, filters, mask):
    """Undo a chunk's filters (the pipeline in reverse); bit i of mask
    set means filter i was skipped for this chunk."""
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, vals = filters[i]
        if fid == 1:                    # deflate
            data = zlib.decompress(data)
        elif fid == 2:                  # shuffle: byte planes
            esize = vals[0] if vals else 1
            n = len(data) // esize * esize
            planes = np.frombuffer(data[:n], dtype=np.uint8)
            data = (planes.reshape(esize, -1).T.tobytes()
                    + bytes(data[n:]))
        elif fid == 3:                  # fletcher32: checksum appended
            body, stored = bytes(data[:-4]), _u(data, len(data) - 4, 4)
            want = _fletcher32(body)
            # libhdf5 before 1.6.3 stored the sum byte-swapped
            if stored not in (want, int.from_bytes(
                    want.to_bytes(4, "little"), "big")):
                raise IOError("HDF5 chunk fails its fletcher32 checksum")
            data = body
        else:
            raise NotImplementedError("HDF5 filter {}".format(fid))
    return data


def _shape(ds):
    version, rank = ds[0], ds[1]
    if version == 1:
        p = 8
    elif version == 2:
        p = 4
        if ds[3] == 2:
            return (0,)
    else:
        raise NotImplementedError("HDF5 dataspace version {}".format(version))
    return tuple(_u(ds, p + 8 * i, 8) for i in range(rank))


class _Node:
    def __init__(self, f, addr):
        self._f = f
        self._addr = addr
        self._msgs = None

    @property
    def messages(self):
        if self._msgs is None:
            self._msgs = self._f.messages(self._addr)
        return self._msgs

    @property
    def attrs(self):
        return self._f.attributes(self.messages)


class Group(_Node):
    def _links(self):
        return self._f.links(self.messages)

    def keys(self):
        return list(self._links())

    def __getitem__(self, path):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(path)
            addr = node._links().get(part)
            if addr is None:
                raise KeyError(path)
            msgs = self._f.messages(addr)
            cls = Dataset if any(t == 0x08 for t, _ in msgs) else Group
            node = cls(self._f, addr)
            node._msgs = msgs
        return node


class Dataset(_Node):
    def _find(self, mtype):
        for t, data in self.messages:
            if t == mtype:
                return data
        return None

    def __getitem__(self, key):
        lay = self._find(0x08)
        if lay[0] not in (3, 4):     # same compact/contiguous fields
            raise NotImplementedError("HDF5 layout version {}".format(lay[0]))
        if lay[1] == 2:
            raw = self._chunked(lay)
        elif self._find(0x0B) is not None:
            raise NotImplementedError("filtered HDF5 datasets that are not "
                                      "chunked")
        elif lay[1] == 0:
            raw = lay[4:4 + _u(lay, 2, 2)]
        elif lay[1] == 1:
            addr, size = _u(lay, 2, 8), _u(lay, 10, 8)
            raw = b"" if addr == _UNDEF else self._f._buf[addr:addr + size]
        else:
            raise NotImplementedError("HDF5 layout class {}".format(lay[1]))
        value = self._f.decode(self._find(0x03), self._find(0x01), raw)
        return value if key == () or key is Ellipsis else value[key]

    def _chunked(self, lay):
        """Raw bytes (C order) of a chunked dataset, chunks unfiltered and
        placed; chunks never written read as zeros (the default fill)."""
        space = self._find(0x01)
        shape = _shape(space)
        if lay[0] == 3:
            ndims = lay[2]
            dims = [_u(lay, 11 + 4 * i, 4) for i in range(ndims)]
            index = _u(lay, 3, 8)
            chunks = (() if index == _UNDEF
                      else self._f.chunks(index, ndims))
        else:
            flags, ndims, enc = lay[2], lay[3], lay[4]
            dims = [_u(lay, 5 + enc * i, enc) for i in range(ndims)]
            chunks = _v4_chunks(self._f._buf, lay, 5 + enc * ndims, flags,
                                tuple(dims[:-1]), dims[-1], shape,
                                _maxshape(space))
        chunk, esize = tuple(dims[:-1]), dims[-1]
        out = np.zeros(tuple(shape) + (esize,), dtype=np.uint8)
        filters = _filters(self._find(0x0B))
        for offsets, mask, data in chunks:
            data = _unfilter(data, filters, mask)
            block = np.frombuffer(data, dtype=np.uint8)[
                :int(np.prod(chunk)) * esize].reshape(chunk + (esize,))
            dst = tuple(slice(o, min(o + c, n))
                        for o, c, n in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start)
                                   for d in dst)]
        return out.tobytes()


def _maxshape(ds):
    """Maximum dimensions of a dataspace (None where unlimited), or its
    dimensions where it stores none."""
    shape = _shape(ds)
    if not ds[2] & 1:
        return shape
    p = (8 if ds[0] == 1 else 4) + 8 * len(shape)
    return tuple(None if _u(ds, p + 8 * i, 8) == _UNDEF
                 else _u(ds, p + 8 * i, 8) for i in range(len(shape)))


def _v4_chunks(buf, lay, p, flags, chunk, esize, shape, maxshape):
    """(offsets, filter mask, stored bytes) of every chunk of a layout
    version 4 chunked dataset, whose chunk index type is at lay[p]."""
    kind = lay[p]
    nbytes = int(np.prod(chunk)) * esize
    if kind == 1:                       # single chunk: the whole dataset
        size, mask = nbytes, 0
        if flags & 0x02:                # filtered
            size, mask = _u(lay, p + 1, 8), _u(lay, p + 9, 4)
            p += 12
        addr = _u(lay, p + 1, 8)
        if addr != _UNDEF:
            yield (0,) * len(chunk), mask, bytes(buf[addr:addr + size])
        return
    if kind == 2:
        raise NotImplementedError("HDF5 chunk index: implicit")
    if kind == 5:
        raise NotImplementedError(
            "HDF5 chunk index: version 2 B-tree (datasets with more than "
            "one unlimited dimension)")
    if kind == 3:                       # fixed array
        entries = _fixed_array(buf, _u(lay, p + 2, 8))
    elif kind == 4:                     # extensible array
        if any(m is None for m in maxshape[1:]):
            raise NotImplementedError(
                "HDF5 extensible-array chunk index over an unlimited "
                "dimension other than the first")
        entries = _extensible_array(buf, _u(lay, p + 6, 8))
    else:
        raise NotImplementedError("HDF5 chunk index type {}".format(kind))
    # chunks are numbered in C order over the chunk grid of the maximum
    # dimensions (the first, if unlimited, varies slowest)
    grid = [-(-(m if m is not None else n) // c)
            for m, n, c in zip(maxshape, shape, chunk)]
    for i, (addr, entry) in enumerate(entries):
        if addr == _UNDEF:
            continue
        if len(entry) > 8:              # filtered: size, filter mask
            size = _u(entry, 8, len(entry) - 12)
            mask = _u(entry, len(entry) - 4, 4)
        else:
            size, mask = nbytes, 0
        scaled = []
        for g in reversed(grid[1:]):
            i, r = divmod(i, g)
            scaled.append(r)
        scaled.append(i)
        yield (tuple(s * c for s, c in zip(reversed(scaled), chunk)), mask,
               bytes(buf[addr:addr + size]))


def _fixed_array(buf, addr):
    """[(chunk address, raw entry)] of a fixed array (FAHD)."""
    _expect(buf, addr, b"FAHD")
    esize, page_bits = buf[addr + 6], buf[addr + 7]
    n, dblk = _u(buf, addr + 8, 8), _u(buf, addr + 16, 8)
    _expect(buf, dblk, b"FADB")
    page = 1 << page_bits
    if n <= page:
        p = dblk + 14
        return [(_u(buf, p + i * esize, 8),
                 bytes(buf[p + i * esize:p + (i + 1) * esize]))
                for i in range(n)]
    npages = -(-n // page)
    bitmap = dblk + 14
    start = bitmap + (npages + 7) // 8 + 4
    out = []
    for i in range(n):
        pg = i // page
        if not buf[bitmap + pg // 8] & (0x80 >> (pg % 8)):
            out.append((_UNDEF, b""))   # page never written
            continue
        e = start + pg * (page * esize + 4) + (i % page) * esize
        out.append((_u(buf, e, 8), bytes(buf[e:e + esize])))
    return out


def _extensible_array(buf, addr):
    """[(chunk address, raw entry)] of an extensible array (EAHD), the
    lookup of H5EA.c."""
    _expect(buf, addr, b"EAHD")
    esize, max_bits, idx_elmts = buf[addr + 6], buf[addr + 7], buf[addr + 8]
    min_elmts, min_ptrs, page_bits = (buf[addr + 9], buf[addr + 10],
                                      buf[addr + 11])
    nset, iblock = _u(buf, addr + 44, 8), _u(buf, addr + 60, 8)
    if iblock == _UNDEF:
        return []
    _expect(buf, iblock, b"EAIB")
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    nsblks = 1 + max_bits - _log2(min_elmts)
    iblock_sblks = 2 * _log2(min_ptrs)
    dblk_addrs = iblock + 14 + idx_elmts * esize
    sblk_addrs = dblk_addrs + 2 * (min_ptrs - 1) * 8
    info, start_idx, start_dblk = [], 0, 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), min_elmts << ((u + 1) // 2)
        info.append((ndblks, nelmts, start_idx, start_dblk))
        start_idx += ndblks * nelmts
        start_dblk += ndblks

    def element(i):
        if i < idx_elmts:
            return iblock + 14 + i * esize
        j = i - idx_elmts
        sblk = _log2(j // min_elmts + 1)
        ndblks, nelmts, first, first_dblk = info[sblk]
        e = j - first
        if sblk < iblock_sblks:
            dblk = _u(buf, dblk_addrs + 8 * (first_dblk + e // nelmts), 8)
        else:
            sb = _u(buf, sblk_addrs + 8 * (sblk - iblock_sblks), 8)
            if sb == _UNDEF:
                return None
            _expect(buf, sb, b"EASB")
            init = ((nelmts // page + 7) // 8) * ndblks \
                if nelmts > page else 0
            dblk = _u(buf, sb + 14 + off_size + init + 8 * (e // nelmts), 8)
        if dblk == _UNDEF:
            return None
        _expect(buf, dblk, b"EADB")
        e %= nelmts
        if nelmts <= page:
            return dblk + 14 + off_size + e * esize
        return (dblk + 14 + off_size + 4 + (e // page) * (page * esize + 4)
                + (e % page) * esize)

    out = []
    for i in range(nset):
        p = element(i)
        out.append((_UNDEF, b"") if p is None
                   else (_u(buf, p, 8), bytes(buf[p:p + esize])))
    return out


# -- writer ------------------------------------------------------------------

# Sizes of superblock 0's symbol tables (libhdf5's defaults, which the
# superblock states): a symbol table node holds up to 2 * _LEAF_K names,
# a group B-tree node up to 2 * _NODE_K children.  libhdf5 reads a node's
# full size whatever it holds.
_LEAF_K, _NODE_K = 4, 16
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
# A global heap collection: libhdf5 reads at least 4096 bytes of one.
_GCOL_SIZE = 1 << 16
# Variable-length UTF-8 string (null-terminated padding) of unsigned
# 8-bit characters: what h5py writes for a Python str.
_VLEN_STR = (bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16)
             + bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8))
_HEAP_FREE_NULL = 1         # a local heap's "no free block"


@functools.lru_cache(maxsize=None)     # one entry a dtype
def _encode_dtype(dt):
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10]) + bits.to_bytes(3, "little")
                + dt.itemsize.to_bytes(4, "little")
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        single = dt.itemsize == 4
        bits = 0x20 | ((31 if single else 63) << 8)
        return (bytes([0x11]) + bits.to_bytes(3, "little")
                + dt.itemsize.to_bytes(4, "little")
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize,
                              23 if single else 52, 8 if single else 11,
                              0, 23 if single else 52,
                              127 if single else 1023))
    if dt.kind == "S":
        return (bytes([0x13, 0, 0, 0])
                + max(1, dt.itemsize).to_bytes(4, "little"))
    raise NotImplementedError("cannot write HDF5 datatype {}".format(dt))


def _encode_space(shape):
    return (bytes([1, len(shape), 0, 0, 0, 0, 0, 0])
            + b"".join(int(d).to_bytes(8, "little") for d in shape))


def _message(mtype, data):
    data = bytes(data)
    data += b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


class _WNode:
    def __init__(self, writer):
        self._writer = writer
        self.attrs = {}


class _WDataset(_WNode):
    """A dataset whose bytes are already in the file."""

    def __init__(self, writer, data):
        super().__init__(writer)
        self.dtype_msg, raw, self.shape = writer._encode(data)
        # an empty dataset has no storage: its address is undefined
        self.addr = writer._write(raw) if raw else _UNDEF
        self.nbytes = len(raw)


class _WGroup(_WNode):
    def __init__(self, writer):
        super().__init__(writer)
        self.children = {}

    def __contains__(self, name):
        return name in self.children

    def create_group(self, name):
        head, _, rest = name.strip("/").partition("/")
        grp = self.children.get(head)
        if grp is None:
            grp = self.children[head] = _WGroup(self._writer)
        return grp.create_group(rest) if rest else grp

    def create_dataset(self, name, data):
        parent, _, leaf = name.strip("/").rpartition("/")
        grp = self.create_group(parent) if parent else self
        ds = _WDataset(self._writer, data)
        grp.children[leaf] = ds
        return ds


class Writer(_WGroup):
    """Write a new HDF5 file with the h5py calls `create_group`,
    `create_dataset(name, data=)` and `attrs[key] = value`.

    A dataset's bytes go to the file when it is created, so host memory
    holds names and attributes but no array.  Python str values, as
    attributes or in arrays of str, are variable-length UTF-8 strings in
    global heap collections, as h5py writes them (h5py reads them back as
    str); bytes are fixed-length strings.  Every group is a symbol table
    (v1 B-tree of symbol table nodes, names in a local heap), which holds
    any number of children.  Groups, object headers and the superblock
    are written on `close()` (or at the end of a `with` block)."""

    def __init__(self, filename):
        super().__init__(self)
        self.filename = filename
        self._fh = open(filename, "w+b")
        self._fh.write(bytes(96))
        # the end of the file's space, and the file's own position
        self._eof = self._at = 96
        self._gcol = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._fh is None:
            return
        try:
            root = self._emit(self)
            self._seal()
            btree, heap = self._stab
            sb = (_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                  + struct.pack("<QQQQ", 0, _UNDEF, self._eof, _UNDEF)
                  + struct.pack("<QQII", 0, root, 1, 0)
                  + struct.pack("<QQ", btree, heap))
            self._fh.seek(0)
            self._fh.write(sb)
        finally:
            self._fh.close()
            self._fh = None

    # -- file space ----------------------------------------------------------

    def _write(self, raw):
        """Append raw bytes, zero-padded to 8-byte boundaries; their
        address."""
        addr = self._reserve(len(raw))
        if self._at != addr:
            self._fh.seek(addr)
        self._fh.write(raw)
        self._fh.write(bytes(self._eof - addr - len(raw)))
        self._at = self._eof
        return addr

    def _reserve(self, size):
        addr = self._eof
        self._eof = addr + _pad8(size)
        return addr

    # -- values --------------------------------------------------------------

    def _encode(self, value):
        """(datatype message, raw bytes, shape) of an attribute's or a
        dataset's value."""
        if isinstance(value, str):
            value = np.array(value, dtype=object)
        elif isinstance(value, bytes):
            value = np.array(value, dtype="S{}".format(max(1, len(value))))
        arr = np.asarray(value)
        if arr.dtype.kind in "UO":
            raw = b"".join(self._heap_id(str(s)) for s in arr.ravel())
            return _VLEN_STR, raw, arr.shape
        return _encode_dtype(arr.dtype), arr.tobytes(), arr.shape

    def _heap_id(self, text):
        """Store a string in the open global heap collection (a new one
        when it is full); its 16-byte reference: length, collection,
        index."""
        raw = text.encode("utf-8")
        need = 16 + _pad8(len(raw))
        h = self._gcol
        if (h is None or h["index"] == 0xffff
                or 16 + len(h["data"]) + need + 16 > h["size"]):
            self._seal()
            size = max(_GCOL_SIZE, 16 + need + 16)
            h = self._gcol = {"addr": self._reserve(size), "size": size,
                              "data": bytearray(), "index": 0}
        h["index"] += 1
        h["data"] += (struct.pack("<HH4xQ", h["index"], 0, len(raw)) + raw
                      + bytes(need - 16 - len(raw)))
        return struct.pack("<IQI", len(raw), h["addr"], h["index"])

    def _seal(self):
        """Write the open collection into its space, the rest of it one
        free-space object."""
        h, self._gcol = self._gcol, None
        if h is None:
            return
        body = (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", h["size"])
                + h["data"])
        free = h["size"] - len(body)
        body += struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
        self._fh.seek(h["addr"])
        self._fh.write(body)
        self._at = h["addr"] + len(body)

    def _attr_message(self, name, value):
        dt, raw, shape = self._encode(value)
        nm = name.encode() + b"\0"
        sp = _encode_space(shape)
        body = struct.pack("<BxHHH", 1, len(nm), len(dt), len(sp))
        for part in (nm, dt, sp):
            body += part + b"\0" * (_pad8(len(part)) - len(part))
        return _message(0x0C, body + raw)

    # -- structure -----------------------------------------------------------

    def _emit(self, node):
        """Write a node's object header (a group's children first); its
        address."""
        if isinstance(node, _WGroup):
            names = sorted(node.children)
            addrs = [self._emit(node.children[n]) for n in names]
            node._stab = self._symbol_table(names, addrs)
            msgs = [_message(0x11, struct.pack("<QQ", *node._stab))]
        else:
            msgs = [_message(0x01, _encode_space(node.shape)),
                    _message(0x03, node.dtype_msg),
                    _message(0x08, bytes([3, 1]) + struct.pack(
                        "<QQ", node.addr, node.nbytes))]
        msgs += [self._attr_message(k, v) for k, v in node.attrs.items()]
        body = b"".join(msgs)
        return self._write(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                       len(body)) + body)

    def _symbol_table(self, names, addrs):
        """A group's local heap of names, its symbol table nodes (names in
        byte order, which is how libhdf5 searches them) and the B-tree
        over them; (B-tree address, heap address)."""
        data = bytearray(8)             # offset 0: the empty name
        offs = []
        for n in names:
            offs.append(len(data))
            nm = n.encode() + b"\0"
            data += nm + bytes(_pad8(len(nm)) - len(nm))
        addr = self._eof
        heap = self._write(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(data), _HEAP_FREE_NULL, addr + 32) + data)
        # children of the level being built: (address, heap offset of the
        # last name under it)
        children = []
        for i in range(0, len(names), 2 * _LEAF_K):
            part = range(i, min(i + 2 * _LEAF_K, len(names)))
            snod = (b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(part))
                    + b"".join(struct.pack("<QQII16x", offs[j], addrs[j], 0,
                                           0) for j in part))
            children.append((self._write(snod + bytes(_SNOD_SIZE
                                                      - len(snod))),
                             offs[part[-1]]))
        level = 0
        while True:
            # a node's keys bound its children: key 0 is the last name
            # left of the node (the empty name at the far left), key i + 1
            # the last name under child i
            parts = [children[i:i + 2 * _NODE_K]
                     for i in range(0, len(children), 2 * _NODE_K)] or [[]]
            base = self._eof
            blob, left = bytearray(), 0
            for k, part in enumerate(parts):
                sib = [base + (k + d) * _TREE_SIZE
                       if 0 <= k + d < len(parts) else _UNDEF
                       for d in (-1, 1)]
                node = (b"TREE" + bytes([0, level])
                        + struct.pack("<HQQQ", len(part), sib[0], sib[1],
                                      left)
                        + b"".join(struct.pack("<QQ", a, key)
                                   for a, key in part))
                blob += node + bytes(_TREE_SIZE - len(node))
                left = part[-1][1] if part else left
            self._write(bytes(blob))
            if len(parts) == 1:
                return base, heap
            children = [(base + k * _TREE_SIZE, part[-1][1])
                        for k, part in enumerate(parts)]
            level += 1


# -- whole-file edits ----------------------------------------------------------

class MemoryDataset:
    """A dataset read into memory: its value and its attributes."""

    def __init__(self, value, attrs):
        self.value = value
        self.attrs = attrs


class MemoryGroup:
    """A group read into memory, with the h5py calls of an edit: iteration
    over member names, `g["a/b"]`, and `attrs`, a dict (set, read,
    `del`)."""

    def __init__(self, attrs):
        self.attrs = attrs
        self.members = {}

    def __iter__(self):
        return iter(list(self.members))

    def __getitem__(self, path):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, MemoryGroup) or part not in node.members:
                raise KeyError(path)
            node = node.members[part]
        return node


def _node_attrs(node):
    attrs = dict(node.attrs)
    bad = [k for k, v in attrs.items() if v is None]
    if bad:
        raise NotImplementedError("HDF5 attributes of a datatype this "
                                  "reader does not decode: {}".format(bad))
    return attrs


def _load(node):
    if isinstance(node, Dataset):
        return MemoryDataset(node[()], _node_attrs(node))
    group = MemoryGroup(_node_attrs(node))
    for name in node.keys():
        group.members[name] = _load(node[name])
    return group


def _store(dst, src):
    dst.attrs.update(src.attrs)
    for name, member in src.members.items():
        if isinstance(member, MemoryDataset):
            dst.create_dataset(name, data=member.value).attrs.update(
                member.attrs)
        else:
            _store(dst.create_group(name), member)


def rewrite(filename, edit):
    """edit(root) on the file read into memory (a `MemoryGroup`, every
    dataset's value read), then the edited tree written through `Writer`
    beside the file under a name of this process's and renamed into
    place; returns edit's result.  Where edit raises, the file is left as
    it was."""
    with File(filename) as f:
        tree = _load(f._root)
    result = edit(tree)
    tmp = "{}.{}.tmp".format(filename, os.getpid())
    try:
        with Writer(tmp) as w:
            _store(w, tree)
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return result
