"""FASTA input with kseq.h record semantics: name = header text up to the
first whitespace, sequence = all non-whitespace bytes until the next '>'
header.  Plain or gzip (including bgzip) files, or '-' for stdin: whole
(``read_fasta_bytes``) or one record at a time (``iter_fasta_records``,
for the bounded-memory parse).  A samtools-faidx equivalent
(``write_fai``, ``fetch_contig``) serves the VCF haplotype scan."""

import gzip
import os
import sys
from typing import List, Tuple

import numpy as np

from ..utils.timer import count


_WS = b"\n\r \t"  # the bytes a sequence drops


def _read_all(fname: str) -> bytearray:
    """The file's bytes (decompressed where gzip) in writable memory: a
    plain file is read straight into a buffer of its size."""
    if fname == "-":
        data = bytearray(sys.stdin.buffer.read())
    else:
        with open(fname, "rb") as f:
            size = os.fstat(f.fileno()).st_size  # 0 for a pipe or device
            data = bytearray(size)
            got = f.readinto(data)
            if got < size:  # the file shrank
                del data[got:]
            data += f.read()  # or grew, or is a stream
    if data[:2] == b"\x1f\x8b":  # gzip, incl. concatenated bgzip members
        data = bytearray(gzip.decompress(data))
    return data


def _headers(data: bytearray):
    """The offsets of the '>' bytes that start a line, in order."""
    pos = data.find(b">")
    while pos >= 0:
        if pos == 0 or data[pos - 1] == 10:  # b"\n"
            yield pos
        pos = data.find(b">", pos + 1)


def read_fasta_bytes(fname: str) -> List[Tuple[str, np.ndarray]]:
    """Returns [(name, seq_bytes_u8)] per record: each a 1-D, C-contiguous,
    writable uint8 array.  A record whose bytes hold no whitespace is a
    view of the read buffer (counter ``fasta_views``), which it keeps
    alive; records never share bytes.  Any other record is stripped of
    whitespace in one pass into bytes of its own (``fasta_stripped``)."""
    data = _read_all(fname)
    if not data:
        return []
    starts = list(_headers(data))
    if not starts:
        raise ValueError(f"{fname}: not FASTA (no '>' header)")
    buf = np.frombuffer(data, dtype=np.uint8)
    bounds = starts[1:] + [len(data)]
    records = []
    for hs, end in zip(starts, bounds):
        he = data.find(b"\n", hs, end)
        he = end if he < 0 else he
        header = data[hs + 1: he].decode("ascii", "replace")
        name = header.split()[0] if header.split() else ""
        lo, hi = min(he + 1, end), end
        while hi > lo and data[hi - 1] in _WS:
            hi -= 1
        if all(data.find(c, lo, hi) < 0 for c in _WS):  # memchr each
            seq, path = buf[lo:hi], "fasta_views"
        else:
            seq = np.frombuffer(data[lo:hi].translate(None, _WS),
                                dtype=np.uint8)
            path = "fasta_stripped"
        count(path)
        records.append((name, seq))
    return records


def iter_fasta_records(fname: str, block: int = 8 << 20):
    """Streaming record iterator: yields (name, seq_u8) one record at a
    time, reading the file in ``block``-byte pieces — only the current
    record is resident (the kseq-equivalent path for inputs larger than
    RAM).  Same record semantics as read_fasta_bytes."""
    if fname == "-":
        fh = sys.stdin.buffer
        close = False
    else:
        fh = open(fname, "rb")
        close = True
        magic = fh.read(2)
        fh.seek(0)
        if magic == b"\x1f\x8b":
            fh = gzip.open(fh, "rb")
    try:
        name = None
        parts: List[np.ndarray] = []
        carry = b""
        while True:
            data = fh.read(block)
            if not data:
                break
            data = carry + data
            # keep a partial trailing line in `carry` so headers and the
            # whitespace mask never straddle block boundaries
            cutpos = data.rfind(b"\n")
            if cutpos < 0:
                carry = data
                continue
            carry = data[cutpos + 1:]
            data = data[: cutpos + 1]
            for line in data.split(b"\n"):
                if not line:
                    continue
                if line.startswith(b">"):
                    if name is not None:
                        yield name, _cat_seq(parts)
                    header = line[1:].decode("ascii", "replace").strip()
                    name = header.split()[0] if header.split() else ""
                    parts = []
                elif name is not None:
                    parts.append(_seq_line(line))
                else:
                    raise ValueError(f"{fname}: not FASTA (no '>' header)")
        if carry:
            line = carry
            if line.startswith(b">"):
                if name is not None:
                    yield name, _cat_seq(parts)
                header = line[1:].decode("ascii", "replace").strip()
                name = header.split()[0] if header.split() else ""
                parts = []
            elif name is not None:
                parts.append(_seq_line(line))
            else:
                raise ValueError(f"{fname}: not FASTA (no '>' header)")
        if name is None:
            raise ValueError(f"{fname}: not FASTA (no '>' header)")
        yield name, _cat_seq(parts)
    finally:
        if close:
            fh.close()


def _seq_line(line: bytes) -> np.ndarray:
    """Strip ALL whitespace from a sequence line (read_fasta_bytes
    semantics, not just edges)."""
    arr = np.frombuffer(line, dtype=np.uint8)
    ws = (arr == 32) | (arr == 9) | (arr == 13) | (arr == 10)
    return arr[~ws] if ws.any() else arr


def _cat_seq(parts: List[np.ndarray]) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.ascontiguousarray(np.concatenate(parts))


# -- faidx -------------------------------------------------------------------

def write_fai(fasta_fname: str, fai_fname: str = None) -> str:
    """samtools-faidx-compatible index: name len offset linebases linewidth."""
    fai_fname = fai_fname or fasta_fname + ".fai"
    rows = []
    with open(fasta_fname, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        pos = 0
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    rows.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                length = 0
                offset = pos + len(raw)
                first_line = True
            elif name is not None and line:
                if first_line:
                    linebases = len(line)
                    linewidth = len(raw)
                    first_line = False
                length += len(line)
            pos += len(raw)
        if name is not None:
            rows.append((name, length, offset, linebases, linewidth))
    with open(fai_fname, "w") as f:
        for r in rows:
            f.write("{}\t{}\t{}\t{}\t{}\n".format(*r))
    return fai_fname


def read_fai(fai_fname: str):
    idx = {}
    order = []
    with open(fai_fname) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) < 5:
                continue
            name = parts[0]
            idx[name] = tuple(int(x) for x in parts[1:5])
            order.append(name)
    return idx, order


def fetch_contig(fasta_fname: str, contig: str) -> bytes:
    """fai_fetch equivalent: contig sequence with newlines stripped."""
    fai = fasta_fname + ".fai"
    if not os.path.exists(fai):
        write_fai(fasta_fname)
    idx, _ = read_fai(fai)
    if contig not in idx:
        raise KeyError(f"contig {contig!r} not in {fasta_fname}")
    length, offset, linebases, linewidth = idx[contig]
    nlines = (length + linebases - 1) // linebases if linebases else 0
    nbytes = length + nlines * (linewidth - linebases)
    with open(fasta_fname, "rb") as f:
        f.seek(offset)
        raw = f.read(nbytes)
    return raw.replace(b"\n", b"").replace(b"\r", b"")[:length]
