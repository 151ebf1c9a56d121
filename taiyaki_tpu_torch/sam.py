"""Minimal SAM/BAM alignment reading (no pysam dependency).

Provides just what the pipeline needs (bin/get_refs_from_sam.py,
misc/assess_alignment.py): iterate alignment records with query name, flag,
reference name, reference span, query length/alignment length and CIGAR.

SAM is parsed as text; BAM via the BGZF container (concatenated gzip
members — handled natively by Python's gzip) and the BAM binary record
layout from the SAM spec.
"""

import gzip
import re
import struct

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_BAM_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"


class Alignment:
    """One alignment record."""

    __slots__ = ("query_name", "flag", "reference_name", "reference_start",
                 "cigar", "seq", "mapq", "tags")

    def __init__(self, query_name, flag, reference_name, reference_start,
                 cigar, seq, mapq=0, tags=None):
        self.query_name = query_name
        self.flag = flag
        self.reference_name = reference_name
        self.reference_start = reference_start   # 0-based
        self.cigar = cigar                       # list of (op, length)
        self.seq = seq
        self.mapq = mapq
        self.tags = tags or {}

    def get_tag(self, name):
        return self.tags[name]

    @property
    def is_unmapped(self):
        return self.flag & 0x4 != 0 or self.reference_name is None

    @property
    def is_reverse(self):
        return self.flag & 0x10 != 0

    @property
    def query_length(self):
        """Length of the stored query sequence: soft clips included,
        HARD clips excluded — pysam's query_length, which the reference's
        coverage filter divides by (bin/get_refs_from_sam.py:58)."""
        n = sum(ln for op, ln in self.cigar if op in "MIS=X")
        if n == 0 and self.seq:
            n = len(self.seq)
        return n

    @property
    def query_alignment_length(self):
        """Aligned query bases (M/I/=/X)."""
        return sum(ln for op, ln in self.cigar if op in "MI=X")

    @property
    def reference_length(self):
        """Reference span (M/D/N/=/X)."""
        return sum(ln for op, ln in self.cigar if op in "MDN=X")

    @property
    def reference_end(self):
        return self.reference_start + self.reference_length


def parse_cigar(cigar_str):
    if cigar_str == "*" or not cigar_str:
        return []
    return [(op, int(n)) for n, op in _CIGAR_RE.findall(cigar_str)]


def _parse_sam_tags(fields):
    tags = {}
    for field in fields:
        parts = field.split(":", 2)
        if len(parts) != 3:
            continue
        name, typ, val = parts
        if typ == "i":
            tags[name] = int(val)
        elif typ == "f":
            tags[name] = float(val)
        else:
            tags[name] = val
    return tags


def _iter_sam_text(fh):
    for line in fh:
        if line.startswith("@"):
            continue
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 11:
            continue
        flag = int(fields[1])
        rname = None if fields[2] == "*" else fields[2]
        yield Alignment(
            query_name=fields[0], flag=flag, reference_name=rname,
            reference_start=int(fields[3]) - 1,
            cigar=[(op, n) for op, n in parse_cigar(fields[5])],
            seq=None if fields[9] == "*" else fields[9],
            mapq=int(fields[4]),
            tags=_parse_sam_tags(fields[11:]))


def _iter_bam(fh):
    # stream-decompress: whole nanopore BAMs decompress to multiple GB,
    # so never hold the full file in one bytes object
    gz = gzip.open(fh, "rb")

    def read_exact(n):
        buf = gz.read(n)
        while len(buf) < n:
            more = gz.read(n - len(buf))
            if not more:
                raise EOFError("truncated BAM")
            buf += more
        return buf

    assert read_exact(4) == b"BAM\x01", "Not a BAM file"
    l_text, = struct.unpack("<i", read_exact(4))
    read_exact(l_text)
    n_ref, = struct.unpack("<i", read_exact(4))
    refs = []
    for _ in range(n_ref):
        l_name, = struct.unpack("<i", read_exact(4))
        refs.append(read_exact(l_name)[:-1].decode())
        read_exact(4)  # l_ref
    while True:
        head = gz.read(4)
        if len(head) < 4:
            break
        block_size, = struct.unpack("<i", head)
        rec = read_exact(block_size)
        (ref_id, pos0, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from(
             "<iiBBHHHiiii", rec, 0)
        off = 32
        name = rec[off:off + l_read_name - 1].decode()
        off += l_read_name
        cigar = []
        for _ in range(n_cigar):
            c, = struct.unpack_from("<I", rec, off)
            off += 4
            cigar.append((_BAM_CIGAR_OPS[c & 0xF], c >> 4))
        seq_bytes = rec[off:off + (l_seq + 1) // 2]
        off += (l_seq + 1) // 2
        seq = "".join(
            _SEQ_CODES[(b >> 4) if i % 2 == 0 else (b & 0xF)]
            for i in range(l_seq)
            for b in [seq_bytes[i // 2]])
        off += l_seq  # qual
        tags = _parse_bam_tags(rec, off)
        yield Alignment(
            query_name=name, flag=flag,
            reference_name=refs[ref_id] if ref_id >= 0 else None,
            reference_start=pos0, cigar=cigar,
            seq=seq if l_seq else None, mapq=mapq, tags=tags)


_BAM_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                "I": "<I", "f": "<f"}


def _parse_bam_tags(rec, off):
    tags = {}
    n = len(rec)
    while off + 3 <= n:
        name = rec[off:off + 2].decode()
        typ = chr(rec[off + 2])
        off += 3
        if typ in _BAM_TAG_FMT:
            fmt = _BAM_TAG_FMT[typ]
            val, = struct.unpack_from(fmt, rec, off)
            off += struct.calcsize(fmt)
        elif typ == "A":
            val = chr(rec[off])
            off += 1
        elif typ in ("Z", "H"):
            end = rec.index(0, off)
            val = rec[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(rec[off])
            count, = struct.unpack_from("<I", rec, off + 1)
            fmt = _BAM_TAG_FMT[sub]
            width = struct.calcsize(fmt)
            val = [struct.unpack_from(fmt, rec, off + 5 + i * width)[0]
                   for i in range(count)]
            off += 5 + count * width
        else:
            break  # unknown type; stop parsing aux
        tags[name] = val
    return tags


def iter_alignments(filename):
    """Iterate Alignment records from a SAM or BAM file (auto-detected)."""
    with open(filename, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        with open(filename, "rb") as fh:
            yield from _iter_bam(fh)
    else:
        with open(filename) as fh:
            yield from _iter_sam_text(fh)
