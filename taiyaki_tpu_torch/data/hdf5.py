"""A small HDF5 reader and writer in pure numpy, for machines without h5py.

fast5 files are HDF5.  Where h5py is installed, `open_file` returns an
`h5py.File` and nothing here is used.  Where it is not (the port's GPU
hosts carry only PyTorch's stack), this module reads the uncompressed
subset of HDF5 that fast5 reads need, with the h5py calls fast5utils
makes: `keys()`, `f["a/b"]`, `dict(g.attrs)`, `dset[()]`.

Read: superblock versions 0-3, object header versions 1 and 2 (with
continuation blocks), groups stored as a symbol table (v1 B-tree, local
heap) or as compact link messages, attributes of fixed-point, float,
enum, fixed-length and variable-length string types, contiguous and
compact datasets, and chunked datasets (layout message version 3, chunks
indexed by a v1 B-tree) through the deflate (zlib) and shuffle filters:
the layout of mapped-signal files and of h5py-written fast5.  Dense link storage (groups of more than 8 links
written with libver >= 1.8), layout version 4 chunk indexes, other
filters and shared messages raise NotImplementedError (install h5py for
those).

Write (`Writer`): superblock 0, version-1 object headers, groups as link
messages, contiguous datasets and scalar or array attributes of numeric
and fixed-length string types; h5py and libhdf5 read what it writes.
"""

import mmap
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
                if _u(data, p, 8) != _UNDEF:
                    raise NotImplementedError(
                        "HDF5 groups with dense link storage")
            elif mtype == 0x06:         # link
                name, addr, corder = self._link(data)
                if addr is not None:
                    links[name] = addr
                    order[name] = corder
        if tracked and None not in order.values():
            return dict(sorted(links.items(), key=lambda kv: order[kv[0]]))
        return dict(sorted(links.items()))

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
        buf = self._buf
        _expect(buf, coll, b"GCOL")
        end = coll + _u(buf, coll + 8, 8)
        p = coll + 16
        while p + 16 <= end:
            idx, size = _u(buf, p, 2), _u(buf, p + 8, 8)
            if idx == index:
                return bytes(buf[p + 16:p + 16 + size])
            if idx == 0:
                break
            p += 16 + _pad8(size)
        raise KeyError("global heap object {} not found".format(index))

    def attributes(self, messages):
        out = {}
        for mtype, data in messages:
            if mtype != 0x0C:
                continue
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
        return out


def _expect(buf, addr, signature):
    if buf[addr:addr + 4] != signature:
        raise OSError("corrupt HDF5 file: no {} at {}".format(
            signature.decode(), addr))


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
        if lay[0] != 3:
            raise NotImplementedError(
                "HDF5 chunk index of layout version {} (only the v1 B-tree "
                "of version 3)".format(lay[0]))
        ndims = lay[2]
        btree = _u(lay, 3, 8)
        dims = [_u(lay, 11 + 4 * i, 4) for i in range(ndims)]
        chunk, esize = tuple(dims[:-1]), dims[-1]
        shape = _shape(self._find(0x01))
        out = np.zeros(tuple(shape) + (esize,), dtype=np.uint8)
        filters = _filters(self._find(0x0B))
        if btree != _UNDEF:
            for offsets, mask, data in self._f.chunks(btree, ndims):
                data = _unfilter(data, filters, mask)
                block = np.frombuffer(data, dtype=np.uint8)[
                    :int(np.prod(chunk)) * esize].reshape(chunk + (esize,))
                dst = tuple(slice(o, min(o + c, n))
                            for o, c, n in zip(offsets, chunk, shape))
                out[dst] = block[tuple(slice(0, d.stop - d.start)
                                       for d in dst)]
        return out.tobytes()


# -- writer ------------------------------------------------------------------

def _encode_dtype(dt):
    dt = np.dtype(dt)
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


def _as_value(value):
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        return np.array(value, dtype="S{}".format(max(1, len(value))))
    return np.asarray(value)


def _message(mtype, data):
    data = bytes(data)
    data += b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _attr_message(name, value):
    arr = _as_value(value)
    nm = name.encode() + b"\0"
    dt, sp = _encode_dtype(arr.dtype), _encode_space(arr.shape)
    body = struct.pack("<BxHHH", 1, len(nm), len(dt), len(sp))
    for part in (nm, dt, sp):
        body += part + b"\0" * (_pad8(len(part)) - len(part))
    return _message(0x0C, body + arr.tobytes())


class _WNode:
    def __init__(self):
        self.attrs = {}


class _WDataset(_WNode):
    def __init__(self, data):
        super().__init__()
        self.data = np.ascontiguousarray(data)


class _WGroup(_WNode):
    def __init__(self):
        super().__init__()
        self.children = {}

    def create_group(self, name):
        head, _, rest = name.strip("/").partition("/")
        grp = self.children.setdefault(head, _WGroup())
        return grp.create_group(rest) if rest else grp

    def create_dataset(self, name, data):
        parent, _, leaf = name.strip("/").rpartition("/")
        grp = self.create_group(parent) if parent else self
        ds = _WDataset(np.asarray(data))
        grp.children[leaf] = ds
        return ds


class Writer(_WGroup):
    """Write a new HDF5 file: build groups, datasets and attrs with the
    h5py calls `create_group`, `create_dataset(name, data=)` and
    `attrs[key] = value`; the file is written on `close()` (or at the end
    of a `with` block)."""

    def __init__(self, filename):
        super().__init__()
        self.filename = filename

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()

    def close(self):
        out = bytearray(96)
        root = self._emit(out, self)
        sb = (_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", 4, 16, 0)
              + struct.pack("<QQQQ", 0, _UNDEF, len(out), _UNDEF)
              + struct.pack("<QQII16x", 0, root, 0, 0))
        out[:96] = sb
        with open(self.filename, "wb") as fh:
            fh.write(out)

    @staticmethod
    def _align(out):
        out.extend(b"\0" * (_pad8(len(out)) - len(out)))
        return len(out)

    def _emit(self, out, node):
        msgs = []
        if isinstance(node, _WGroup):
            addrs = {name: self._emit(out, child)
                     for name, child in node.children.items()}
            msgs.append(_message(0x02, bytes([0, 0])
                                 + struct.pack("<QQ", _UNDEF, _UNDEF)))
            msgs.append(_message(0x0A, bytes([0, 0])))
            for name, addr in addrs.items():
                nm = name.encode()
                size_flag = 0 if len(nm) < 256 else 1
                msgs.append(_message(0x06, bytes([1, size_flag])
                                     + len(nm).to_bytes(1 << size_flag,
                                                        "little")
                                     + nm + struct.pack("<Q", addr)))
        else:
            data = node.data
            addr = self._align(out)
            out.extend(data.tobytes())
            msgs.append(_message(0x01, _encode_space(data.shape)))
            msgs.append(_message(0x03, _encode_dtype(data.dtype)))
            msgs.append(_message(0x08, bytes([3, 1]) + struct.pack(
                "<QQ", addr, data.nbytes)))
        msgs += [_attr_message(k, v) for k, v in node.attrs.items()]
        body = b"".join(msgs)
        addr = self._align(out)
        out.extend(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)))
        out.extend(body)
        return addr
