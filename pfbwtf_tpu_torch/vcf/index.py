"""Tabix/CSI index support: contig-level seek into bgzip'd VCFs.

The reference iterates per contig via htslib's synced-reader seek
(`bcf_sr_seek`, the reference's include/vcf_scanner.hpp:156-206) backed by
the `.csi`/`.tbi` indexes shipped next to its fixtures
(tests/data/*.vcf.gz.csi).  This is a clean-room decoder of both index
formats (HTS spec section "Tabix"/"CSI"), reduced to what a contig-subset
scan needs: the minimal BGZF *virtual offset* of each reference sequence,
plus a reader that starts decompression at that offset instead of the file
head — on a biobank-scale VCF this is the difference between seconds and a
full-file scan.

Virtual offsets are ``coffset << 16 | uoffset``: compressed byte offset of
a BGZF block (each block is an independent gzip member) and the
uncompressed offset within it.
"""

import gzip
import io as _io
import struct
from typing import Dict, Iterator, Optional

from ..utils.errors import die


def _bgzf_decompress(fp) -> bytes:
    """All remaining BGZF/gzip members from the current file position."""
    return gzip.GzipFile(fileobj=fp).read()


def _take_i32(buf, off, n=1):
    vals = struct.unpack_from(f"<{n}i", buf, off)
    return (vals[0] if n == 1 else vals), off + 4 * n


def load_index(path: str) -> Dict[str, int]:
    """name -> minimal virtual offset of that contig's records.

    Accepts a ``.csi`` or ``.tbi`` file (auto-detected by magic).  Names
    come from the index itself (both formats store the sequence-name pool
    for tabix-flavored indexes).
    """
    with open(path, "rb") as f:
        raw = _bgzf_decompress(f)
    if raw[:4] == b"CSI\x01":
        return _parse_csi(raw)
    if raw[:4] == b"TBI\x01":
        return _parse_tbi(raw)
    die(f"{path}: not a CSI/TBI index")


def _names_from_pool(pool: bytes):
    return [n.decode() for n in pool.split(b"\x00") if n]


def _parse_csi(b: bytes) -> Dict[str, int]:
    off = 4
    _min_shift, off = _take_i32(b, off)
    _depth, off = _take_i32(b, off)
    l_aux, off = _take_i32(b, off)
    aux = b[off : off + l_aux]
    off += l_aux
    names = []
    if l_aux >= 28:  # tabix conf: 6 int32 + l_nm + name pool
        (l_nm,) = struct.unpack_from("<i", aux, 24)
        names = _names_from_pool(aux[28 : 28 + l_nm])
    n_ref, off = _take_i32(b, off)
    out: Dict[str, int] = {}
    for r in range(n_ref):
        n_bin, off = _take_i32(b, off)
        best: Optional[int] = None
        for _ in range(n_bin):
            _bin, loff = struct.unpack_from("<IQ", b, off)
            off += 12
            n_chunk, off = _take_i32(b, off)
            for _ in range(n_chunk):
                beg, _end = struct.unpack_from("<QQ", b, off)
                off += 16
                if beg and (best is None or beg < best):
                    best = beg
            if loff and (best is None or loff < best):
                best = loff
        if best is not None:
            key = names[r] if r < len(names) else str(r)
            out[key] = best
    return out


def _parse_tbi(b: bytes) -> Dict[str, int]:
    off = 4
    n_ref, off = _take_i32(b, off)
    _conf, off = _take_i32(b, off, 5)  # format, col_seq, col_beg/end, meta
    _skip, off = _take_i32(b, off)
    l_nm, off = _take_i32(b, off)
    names = _names_from_pool(b[off : off + l_nm])
    off += l_nm
    out: Dict[str, int] = {}
    for r in range(n_ref):
        n_bin, off = _take_i32(b, off)
        best: Optional[int] = None
        for _ in range(n_bin):
            (_bin,) = struct.unpack_from("<I", b, off)
            off += 4
            n_chunk, off = _take_i32(b, off)
            for _ in range(n_chunk):
                beg, _end = struct.unpack_from("<QQ", b, off)
                off += 16
                if beg and (best is None or beg < best):
                    best = beg
        n_intv, off = _take_i32(b, off)
        for _ in range(n_intv):
            (ioff,) = struct.unpack_from("<Q", b, off)
            off += 8
            if ioff and (best is None or ioff < best):
                best = ioff
        if best is not None:
            key = names[r] if r < len(names) else str(r)
            out[key] = best
    return out


def find_index(vcf_path: str) -> Optional[str]:
    import os

    for ext in (".csi", ".tbi"):
        p = vcf_path + ext
        if os.path.exists(p):
            return p
    return None


def open_lines_at(fname: str, voffset: int) -> Iterator[bytes]:
    """Line iterator over a bgzip'd file starting at a virtual offset."""
    coffset, uoffset = voffset >> 16, voffset & 0xFFFF
    raw = open(fname, "rb")
    raw.seek(coffset)
    gz = gzip.GzipFile(fileobj=raw)
    if uoffset:
        gz.read(uoffset)
    return _io.BufferedReader(gz)  # type: ignore[arg-type]
