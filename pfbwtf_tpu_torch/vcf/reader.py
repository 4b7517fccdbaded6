"""Minimal VCF/BCF reader (vcf_scanner.hpp equivalent).

The reference links htslib for VCF/BCF decoding (vcf_scanner.hpp:9-13).
This environment has no htslib/pysam, so both formats are decoded
directly: VCF text line-by-line, and BCF2 (the binary container, spec
section 6 of VCFv4.x) record-by-record from its typed-value encoding;
.vcf.gz / .bcf (bgzip = concatenated gzip members) stream through
Python's zlib-backed gzip module.

Scalability design (unlike htslib's record-at-a-time API, the pipeline
scans the same VCF once per haplotype, so records are parsed ONCE and
kept):

* the file is parsed STREAMING — line iteration over the (de)compressing
  reader, never materializing the decompressed text;
* records are stored COLUMNAR per contig: positions as one int64 array,
  genotypes as one (nrec, nsamples, 2) int16 matrix, allele/ID strings in
  shared byte arenas with offset arrays — O(1) Python objects per contig
  instead of O(records) — so a panel-scale VCF holds in a few bytes per
  genotype;
* ``records_for_contig`` yields lightweight per-record views for the
  scanners (compat API).
"""

import gzip
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np


@dataclass
class VCFRecord:
    """Per-record view over the columnar store (scan-time compat API)."""

    contig: str
    pos: int  # 0-based (like htslib rec->pos)
    vid: str
    alleles: List[str]  # [ref, alt1, alt2, ...]
    gts: "GTView"
    qual: float = float("nan")  # QUAL column ('.' -> nan)
    filter: str = "."  # FILTER column
    info: str = "."  # raw INFO column ("K=V;K2=V2;FLAG"; BCF re-encoded)
    fmt: str = "."  # raw FORMAT + sample columns ("GT:DP\tv\tv..."),
    # populated only under store_format=True (opt-in: panel-scale memory)

    @property
    def n_allele(self) -> int:
        return len(self.alleles)


class GTView:
    """rec.gts[sample][hap] over one row of the GT matrix."""

    __slots__ = ("_row",)

    def __init__(self, row):
        self._row = row

    def __getitem__(self, sample_idx):
        return self._row[sample_idx]

    def __len__(self):
        return self._row.shape[0]

    def __bool__(self):
        return self._row.size > 0


class _ContigStore:
    """Columnar record storage for one contig."""

    __slots__ = (
        "pos", "gts", "allele_arena", "allele_off", "allele_cnt",
        "id_arena", "id_off", "qual", "filter_arena", "filter_off",
        "info_arena", "info_off", "fmt_arena", "fmt_off",
    )

    def __init__(self, pos, gts, allele_arena, allele_off, allele_cnt,
                 id_arena, id_off, qual=None, filter_arena=b"",
                 filter_off=None, info_arena=b"", info_off=None,
                 fmt_arena=b"", fmt_off=None):
        self.pos = pos  # (nrec,) int64
        self.gts = gts  # (nrec, nsamples, 2) int16; -1 = missing
        self.allele_arena = allele_arena  # bytes: alleles joined by ','
        self.allele_off = allele_off  # (total_alleles+1,) int64 offsets
        self.allele_cnt = allele_cnt  # (nrec+1,) int64 prefix counts
        self.id_arena = id_arena
        self.id_off = id_off  # (nrec+1,) int64
        nrec = pos.shape[0]
        self.qual = (
            qual if qual is not None else np.full(nrec, np.nan)
        )  # (nrec,) float64, nan = '.'
        self.filter_arena = filter_arena
        self.filter_off = (
            filter_off
            if filter_off is not None
            else np.zeros(nrec + 1, dtype=np.int64)
        )
        self.info_arena = info_arena
        self.info_off = (
            info_off
            if info_off is not None
            else np.zeros(nrec + 1, dtype=np.int64)
        )
        self.fmt_arena = fmt_arena
        self.fmt_off = (
            fmt_off
            if fmt_off is not None
            else np.zeros(nrec + 1, dtype=np.int64)
        )

    def __len__(self):
        return self.pos.shape[0]

    def alleles_of(self, i: int) -> List[str]:
        a, b = self.allele_cnt[i], self.allele_cnt[i + 1]
        return [
            self.allele_arena[self.allele_off[j]: self.allele_off[j + 1]]
            .decode()
            for j in range(a, b)
        ]

    def id_of(self, i: int) -> str:
        return self.id_arena[self.id_off[i]: self.id_off[i + 1]].decode()

    def filter_of(self, i: int) -> str:
        s = self.filter_arena[self.filter_off[i]: self.filter_off[i + 1]]
        return s.decode() if s else "."

    def info_of(self, i: int) -> str:
        s = self.info_arena[self.info_off[i]: self.info_off[i + 1]]
        return s.decode() if s else "."

    def fmt_of(self, i: int) -> str:
        s = self.fmt_arena[self.fmt_off[i]: self.fmt_off[i + 1]]
        return s.decode() if s else "."


class _ContigBuilder:
    __slots__ = ("pos", "gts", "alleles", "ids", "quals", "filters",
                 "infos", "fmts", "_gt_blocks")

    GT_BLOCK = 1024  # rows per int16 block (bounds python-list overhead)

    def __init__(self):
        self.pos: List[int] = []
        self.gts: List = []  # pending rows; blocks of GT_BLOCK -> int16
        self.alleles: List[bytes] = []  # per record: b"ref,alt1,..."
        self.ids: List[bytes] = []
        self.quals: List[float] = []
        self.filters: List[bytes] = []
        self.infos: List[bytes] = []
        self.fmts: List[bytes] = []  # raw FORMAT+samples, only opt-in
        self._gt_blocks: List[np.ndarray] = []

    def add_gt_row(self, row: List[int]):
        """Append one record's flattened GT row, converting to compact
        int16 blocks as we go — a 2,500-sample row as a python int list
        is ~35x the bytes of its int16 form, which is the difference
        between parsing a biobank panel and OOM."""
        self.gts.append(row)
        if len(self.gts) >= self.GT_BLOCK:
            self._gt_blocks.append(np.array(self.gts, dtype=np.int16))
            self.gts = []

    def _gt_matrix(self, nrec: int, nsamples: int) -> np.ndarray:
        if self.gts:
            self._gt_blocks.append(np.array(self.gts, dtype=np.int16))
            self.gts = []
        if not self._gt_blocks:
            return np.zeros((0, nsamples, 2), dtype=np.int16)
        nbytes = nrec * nsamples * 2 * 2
        spill_mb = int(os.environ.get("PFBWT_GT_MMAP_MB", "4096"))
        if nbytes > spill_mb << 20:
            import tempfile

            f = tempfile.NamedTemporaryFile(
                prefix="pfbwt_gt", suffix=".mm"
            )
            out = np.memmap(
                f, dtype=np.int16, mode="w+", shape=(nrec, nsamples, 2)
            )
            out._pfbwt_backing = f  # keep the fd alive  # type: ignore
        else:
            out = np.empty((nrec, nsamples, 2), dtype=np.int16)
        at = 0
        for blk in self._gt_blocks:
            k = blk.shape[0]
            out[at : at + k] = blk.reshape(k, nsamples, 2)
            at += k
        self._gt_blocks = []
        return out

    def finish(self, nsamples: int) -> _ContigStore:
        nrec = len(self.pos)
        pos = np.array(self.pos, dtype=np.int64)
        gts = self._gt_matrix(nrec, nsamples)
        cnt = np.zeros(nrec + 1, dtype=np.int64)
        lens: List[int] = []
        for i, rec_alleles in enumerate(self.alleles):
            parts = rec_alleles.split(b",") if rec_alleles else []
            cnt[i + 1] = cnt[i] + len(parts)
            lens.extend(len(x) for x in parts)
        arena = b"".join(
            x for rec in self.alleles for x in rec.split(b",")
        )
        off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(np.array(lens, dtype=np.int64), out=off[1:])
        id_off = np.zeros(nrec + 1, dtype=np.int64)
        np.cumsum(np.array([len(x) for x in self.ids], np.int64),
                  out=id_off[1:])
        qual = (
            np.array(self.quals, dtype=np.float64)
            if len(self.quals) == nrec
            else np.full(nrec, np.nan)
        )
        filt_off = np.zeros(nrec + 1, dtype=np.int64)
        if len(self.filters) == nrec:
            np.cumsum(
                np.array([len(x) for x in self.filters], np.int64),
                out=filt_off[1:],
            )
            filt_arena = b"".join(self.filters)
        else:
            filt_arena = b""
        info_off = np.zeros(nrec + 1, dtype=np.int64)
        if len(self.infos) == nrec:
            np.cumsum(
                np.array([len(x) for x in self.infos], np.int64),
                out=info_off[1:],
            )
            info_arena = b"".join(self.infos)
        else:
            info_arena = b""
        fmt_off = np.zeros(nrec + 1, dtype=np.int64)
        if len(self.fmts) == nrec:
            np.cumsum(
                np.array([len(x) for x in self.fmts], np.int64),
                out=fmt_off[1:],
            )
            fmt_arena = b"".join(self.fmts)
        else:
            fmt_arena = b""
        return _ContigStore(
            pos, gts, arena, off, cnt, b"".join(self.ids), id_off,
            qual, filt_arena, filt_off, info_arena, info_off,
            fmt_arena, fmt_off,
        )


class _RecordSeq:
    """Reiterable lazy record sequence over a contig's columnar store:
    views are built per access, never stored."""

    __slots__ = ("_contig", "_st")

    def __init__(self, contig: str, st: Optional[_ContigStore]):
        self._contig = contig
        self._st = st

    def __len__(self):
        return len(self._st) if self._st is not None else 0

    def __getitem__(self, i: int) -> VCFRecord:
        st = self._st
        if st is None or not (0 <= i < len(st)):
            raise IndexError(i)
        return VCFRecord(
            self._contig,
            int(st.pos[i]),
            st.id_of(i),
            st.alleles_of(i),
            GTView(st.gts[i]),
            qual=float(st.qual[i]),
            filter=st.filter_of(i),
            info=st.info_of(i),
            fmt=st.fmt_of(i),
        )

    def __iter__(self) -> Iterator[VCFRecord]:
        for i in range(len(self)):
            yield self[i]


def _open_lines(fname: str):
    """Streaming line iterator; transparent for bgzip/gzip inputs."""
    with open(fname, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fname, "rb")
    return open(fname, "rb")


# -- BCF2 typed-value decoding (spec: VCFv4.x section 6.3) -------------------

_BCF_MISSING = {1: -0x80, 2: -0x8000, 3: -0x80000000}
_BCF_EOV = {1: -0x7F, 2: -0x7FFF, 3: -0x7FFFFFFF}
_BCF_WIDTH = {0: 0, 1: 1, 2: 2, 3: 4, 5: 4, 7: 1}  # 0 = MISSING (no payload)
_BCF_DTYPE = {1: "<i1", 2: "<i2", 3: "<i4", 5: "<f4", 7: "S1"}


_BCF_F_MISSING = 0x7F800001  # float bit patterns (spec section 6.3.3)
_BCF_F_EOV = 0x7F800002


def _bcf_fmt_texts(is_gt: bool, t: int, cnt: int, n_sample: int,
                   data: bytes) -> List[bytes]:
    """One BCF FORMAT tag -> per-sample text values (the VCF column
    surface), honoring MISSING/END_OF_VECTOR sentinels.  GT vectors are
    re-encoded as a/b with the phase bit choosing | vs / (spec 6.3.3;
    the leading value's phase bit is ignored, as in htslib)."""
    if t == 0 or cnt == 0:
        return [b"."] * n_sample
    if t == 7:  # fixed-width char blobs, NUL-padded
        return [
            (data[s * cnt : (s + 1) * cnt].rstrip(b"\x00") or b".")
            for s in range(n_sample)
        ]
    if t == 5:
        bits = np.frombuffer(data, dtype="<u4").reshape(n_sample, cnt)
        vals = np.frombuffer(data, dtype="<f4").reshape(n_sample, cnt)
        out = []
        for s in range(n_sample):
            parts = []
            for j in range(cnt):
                b = int(bits[s, j])
                if b == _BCF_F_EOV:
                    break
                parts.append(
                    b"." if b == _BCF_F_MISSING
                    else repr(float(vals[s, j])).encode()
                )
            out.append(b",".join(parts) or b".")
        return out
    arr = (
        np.frombuffer(data, dtype=_BCF_DTYPE[t])
        .astype(np.int64)
        .reshape(n_sample, cnt)
    )
    eov, miss = _BCF_EOV[t], _BCF_MISSING[t]
    out = []
    for s in range(n_sample):
        parts = []
        for j in range(cnt):
            v = int(arr[s, j])
            if v == eov:
                break
            if is_gt:
                sep = b"" if j == 0 else (b"|" if v & 1 else b"/")
                al = b"." if v <= 0 else str((v >> 1) - 1).encode()
                parts.append(sep + al)
            else:
                parts.append(b"." if v == miss else str(v).encode())
        if is_gt:
            out.append(b"".join(parts) or b".")
        else:
            out.append(b",".join(parts) or b".")
    return out


class _BcfBuf:
    """Cursor over one record's shared/indiv byte block."""

    __slots__ = ("b", "o")

    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def take(self, n: int) -> bytes:
        v = self.b[self.o : self.o + n]
        self.o += n
        return v

    def typed_header(self):
        """Returns (type, count) resolving the 15 = long-count escape."""
        d = self.b[self.o]
        self.o += 1
        t, cnt = d & 0x0F, d >> 4
        if cnt == 15:
            cnt = int(self.typed_ints()[0])
        return t, cnt

    def typed_ints(self) -> np.ndarray:
        """One typed value decoded as an int64 array (int types only)."""
        t, cnt = self.typed_header()
        if cnt == 0:
            return np.zeros(0, np.int64)
        raw = np.frombuffer(
            self.take(cnt * _BCF_WIDTH[t]), dtype=_BCF_DTYPE[t]
        )
        return raw.astype(np.int64)

    def typed_string(self) -> bytes:
        t, cnt = self.typed_header()
        if t == 0 or cnt == 0:  # spec-legal MISSING / empty typed value
            return b""
        data = self.take(cnt * _BCF_WIDTH[t])
        return data if t == 7 else b""

    def skip_typed(self):
        t, cnt = self.typed_header()
        if t != 0:
            self.take(cnt * _BCF_WIDTH[t])


class VCF:
    def __init__(self, fname: str, contigs: Optional[List[str]] = None,
                 store_format: bool = False):
        """``contigs``: restrict parsing to these contigs.  With a
        ``.csi``/``.tbi`` index next to a bgzip'd VCF the reader SEEKS to
        each contig's first record (the reference's bcf_sr_seek workflow,
        vcf_scanner.hpp:156-206) instead of scanning the whole file."""
        self.fname = fname
        self.contigs: List[str] = []  # header ##contig order
        self.samples: List[str] = []
        self._store: dict = {}  # contig -> _ContigStore
        self._restrict = list(contigs) if contigs is not None else None
        # opt-in raw FORMAT retention: FMT/TAG filter expressions need the
        # per-sample columns, which at panel scale dominate memory — only
        # kept when a consumer asks (htslib re-reads the file instead)
        self._store_format = store_format
        self._parse(fname)

    def _parse(self, fname: str):
        used_index = False
        if self._restrict is not None:
            from . import index as _index

            ipath = _index.find_index(fname)
            with _open_lines(fname) as probe:
                is_bcf = (
                    probe.peek(3)[:3] if hasattr(probe, "peek") else b""
                ) == b"BCF"
            if ipath and not is_bcf:
                idx = _index.load_index(ipath)
                self._parse_text(
                    self._indexed_lines(fname, self._restrict, idx)
                )
                used_index = True
        if not used_index:
            with _open_lines(fname) as fp:
                head = fp.peek(3)[:3] if hasattr(fp, "peek") else b""
                if head == b"BCF":
                    self._parse_bcf(fp)
                else:
                    self._parse_text(fp)
        if self._restrict is not None:
            want = set(self._restrict)
            self._store = {
                c: st for c, st in self._store.items() if c in want
            }
            self.contigs = [c for c in self.contigs if c in want]

    def _indexed_lines(self, fname: str, wanted: List[str], idx):
        """Header lines from the file head, then each wanted contig's
        record lines starting at its indexed virtual offset (stopping at
        the first record of a different contig)."""
        from . import index as _index

        with _open_lines(fname) as fp:
            for line in fp:
                if not line.startswith(b"#"):
                    break
                yield line
        for c in wanted:
            vo = idx.get(c)
            if vo is None:
                continue
            target = c.encode()
            fp2 = _index.open_lines_at(fname, vo)
            try:
                seen = False
                for line in fp2:
                    col0 = line.split(b"\t", 1)[0]
                    if col0 == target:
                        seen = True
                        yield line
                    elif seen:
                        break
            finally:
                fp2.close()

    def _parse_text(self, fp):
        contig_seen: List[str] = []
        builders: dict = {}
        for raw in fp:
            line = raw.rstrip(b"\n").rstrip(b"\r")
            if not line:
                continue
            if line.startswith(b"##"):
                if line.startswith(b"##contig="):
                    inner = line[len(b"##contig=<"):].rstrip(b">")
                    for fieldkv in inner.split(b","):
                        if fieldkv.startswith(b"ID="):
                            self.contigs.append(fieldkv[3:].decode())
                continue
            if line.startswith(b"#CHROM"):
                cols = line.split(b"\t")
                self.samples = (
                    [c.decode() for c in cols[9:]]
                    if len(cols) > 9
                    else []
                )
                continue
            cols = line.split(b"\t")
            if len(cols) < 8:
                continue
            contig = cols[0].decode()
            b = builders.get(contig)
            if b is None:
                b = builders[contig] = _ContigBuilder()
                contig_seen.append(contig)
            b.pos.append(int(cols[1]) - 1)
            b.ids.append(cols[2])
            alts = cols[4] if cols[4] not in (b".", b"") else b""
            b.alleles.append(cols[3] + b"," + alts if alts else cols[3])
            try:
                b.quals.append(float(cols[5]))
            except ValueError:
                b.quals.append(float("nan"))
            b.filters.append(cols[6])
            b.infos.append(cols[7] if cols[7] not in (b".", b"") else b"")
            if self._store_format and len(cols) > 8:
                b.fmts.append(b"\t".join(cols[8:]))
            fmt = cols[8].split(b":") if len(cols) > 8 else []
            gt_idx = fmt.index(b"GT") if b"GT" in fmt else -1
            row: List[int] = []
            for s in cols[9:]:
                if gt_idx < 0:
                    row.extend((-1, -1))
                    continue
                parts = s.split(b":")
                gt_str = parts[gt_idx] if gt_idx < len(parts) else b"."
                hap = []
                for tok in gt_str.replace(b"|", b"/").split(b"/"):
                    try:
                        hap.append(int(tok))
                    except ValueError:
                        hap.append(-1)
                # haploid record: reuse the single value
                # (vcf_scanner.hpp:34-36)
                if len(hap) == 1:
                    hap = [hap[0], hap[0]]
                row.extend(hap[:2])
            b.add_gt_row(row)
        nsamples = len(self.samples)
        for contig, b in builders.items():
            self._store[contig] = b.finish(nsamples)
        if not self.contigs:
            self.contigs = contig_seen

    def _parse_bcf(self, fp):
        """BCF2 record stream -> the same columnar stores as the text path.

        Clean-room decode of the binary container (VCFv4.x spec section 6;
        the reference gets this via htslib, vcf_scanner.hpp:9-13): header
        dictionaries (FILTER/INFO/FORMAT string dict with implicit PASS=0,
        contig dict, both honoring explicit IDX= keys), then per record the
        shared block (chrom/pos/qual/ID/alleles/FILTER) and the indiv
        block's GT vectors with missing/END_OF_VECTOR sentinel handling.
        """
        import struct

        magic = fp.read(5)
        if magic[:4] != b"BCF\x02":
            raise ValueError(f"unsupported BCF version {magic!r}")
        (l_text,) = struct.unpack("<I", fp.read(4))
        header = fp.read(l_text).rstrip(b"\x00")

        str_dict: dict = {0: b"PASS"}
        str_ids: dict = {b"PASS": 0}  # ID string -> index (htslib: one
        # index per DISTINCT ID across FILTER/INFO/FORMAT — e.g. DP in
        # both INFO and FORMAT shares an index)
        contig_dict: dict = {}
        next_str, next_ctg = 1, 0

        def _fields(line: bytes) -> dict:
            inner = line[line.index(b"<") + 1 :].rstrip(b">")
            out = {}
            for kv in inner.split(b","):
                if b"=" in kv:
                    k, v = kv.split(b"=", 1)
                    out[k] = v.strip(b'"')
            return out

        for line in header.split(b"\n"):
            if line.startswith((b"##FILTER=", b"##INFO=", b"##FORMAT=")):
                f = _fields(line)
                ident = f.get(b"ID", b"?")
                if ident == b"PASS":
                    continue  # implicit index 0
                if b"IDX" in f:
                    idx = int(f[b"IDX"])
                elif ident in str_ids:
                    idx = str_ids[ident]  # repeated ID: reuse its index
                else:
                    idx, next_str = next_str, next_str + 1
                if idx not in str_dict:
                    str_dict[idx] = ident
                str_ids.setdefault(ident, idx)
                next_str = max(next_str, idx + 1)
            elif line.startswith(b"##contig="):
                f = _fields(line)
                if b"IDX" in f:
                    idx = int(f[b"IDX"])
                else:
                    idx, next_ctg = next_ctg, next_ctg + 1
                contig_dict[idx] = f.get(b"ID", b"?").decode()
                next_ctg = max(next_ctg, idx + 1)
            elif line.startswith(b"#CHROM"):
                cols = line.split(b"\t")
                self.samples = (
                    [c.decode() for c in cols[9:]] if len(cols) > 9 else []
                )
        self.contigs = [contig_dict[i] for i in sorted(contig_dict)]
        gt_key = next(
            (i for i, v in str_dict.items() if v == b"GT"), -1
        )

        builders: dict = {}
        contig_seen: List[str] = []
        while True:
            hdr8 = fp.read(8)
            if len(hdr8) < 8:
                break
            l_shared, l_indiv = struct.unpack("<II", hdr8)
            shared = _BcfBuf(fp.read(l_shared))
            indiv = _BcfBuf(fp.read(l_indiv))
            chrom, pos, _rlen = struct.unpack("<iii", shared.take(12))
            (qual_bits,) = struct.unpack("<I", shared.take(4))
            qual = (
                float("nan")
                if qual_bits == 0x7F800001
                else struct.unpack("<f", qual_bits.to_bytes(4, "little"))[0]
            )
            (n_ai,) = struct.unpack("<I", shared.take(4))
            n_info, n_allele = n_ai & 0xFFFF, n_ai >> 16
            (n_fs,) = struct.unpack("<I", shared.take(4))
            n_sample, n_fmt = n_fs & 0xFFFFFF, n_fs >> 24
            vid = shared.typed_string() or b"."
            alleles = [shared.typed_string() for _ in range(n_allele)]
            filt_idx = shared.typed_ints()
            filt = (
                b";".join(str_dict.get(int(i), b"?") for i in filt_idx)
                if filt_idx.size
                else b"."
            )
            # INFO: re-encode key/value pairs as the text column so the
            # -i/-e filter engine sees the same surface as text VCFs
            # (float formatting may differ from the original text; numeric
            # filter comparisons are unaffected)
            info_parts: List[bytes] = []
            for _ in range(n_info):
                ikey = int(shared.typed_ints()[0])
                t, cnt = shared.typed_header()
                kname = str_dict.get(ikey, b"?")
                if t == 0 or cnt == 0:
                    info_parts.append(kname)  # FLAG
                elif t == 7:
                    info_parts.append(
                        kname + b"=" + shared.take(cnt))
                elif t == 5:
                    vals = np.frombuffer(
                        shared.take(cnt * 4), dtype="<f4")
                    info_parts.append(kname + b"=" + b",".join(
                        repr(float(v)).encode() for v in vals))
                else:
                    vals = np.frombuffer(
                        shared.take(cnt * _BCF_WIDTH[t]),
                        dtype=_BCF_DTYPE[t]).astype(np.int64)
                    info_parts.append(kname + b"=" + b",".join(
                        str(int(v)).encode() for v in vals))
            info_bytes = b";".join(info_parts)

            row: List[int] = []
            got_gt = False
            fmt_names: List[bytes] = []
            fmt_cols: List[List[bytes]] = []
            for _ in range(n_fmt):
                key = int(indiv.typed_ints()[0])
                t, cnt = indiv.typed_header()
                data = indiv.take(n_sample * cnt * _BCF_WIDTH[t])
                if self._store_format and n_sample:
                    # re-encode this tag's per-sample values as the text
                    # column surface the FMT/ filter engine consumes
                    fmt_names.append(str_dict.get(key, b"?"))
                    fmt_cols.append(
                        _bcf_fmt_texts(key == gt_key, t, cnt, n_sample,
                                       data)
                    )
                if key != gt_key or t not in (1, 2, 3) or cnt == 0:
                    continue
                got_gt = True
                arr = (
                    np.frombuffer(data, dtype=_BCF_DTYPE[t])
                    .astype(np.int64)
                    .reshape(n_sample, cnt)
                )
                eov = _BCF_EOV[t]
                for s in range(n_sample):
                    vals = [int(v) for v in arr[s] if int(v) != eov]
                    hap = [(v >> 1) - 1 if v > 0 else -1 for v in vals]
                    if len(hap) == 1:
                        hap = [hap[0], hap[0]]  # vcf_scanner.hpp:34-36
                    elif not hap:
                        hap = [-1, -1]
                    row.extend(hap[:2])
            if not got_gt:
                row = [-1, -1] * n_sample
            if self._store_format:
                if fmt_names:
                    samp_cols = [
                        b":".join(col[s] for col in fmt_cols)
                        for s in range(n_sample)
                    ]
                    fmt_text = b"\t".join(
                        [b":".join(fmt_names)] + samp_cols
                    )
                else:
                    fmt_text = b"-"  # record has no FORMAT block

            contig = contig_dict.get(chrom, str(chrom))
            b = builders.get(contig)
            if b is None:
                b = builders[contig] = _ContigBuilder()
                contig_seen.append(contig)
            b.pos.append(pos)
            b.ids.append(vid)
            b.alleles.append(b",".join(a for a in alleles if a))
            b.quals.append(qual)
            b.filters.append(filt)
            b.infos.append(info_bytes)
            if self._store_format:
                b.fmts.append(fmt_text)
            b.add_gt_row(row)

        nsamples = len(self.samples)
        for contig, b in builders.items():
            self._store[contig] = b.finish(nsamples)
        if not self.contigs:
            self.contigs = contig_seen

    def n_records(self, contig: str) -> int:
        st = self._store.get(contig)
        return len(st) if st is not None else 0

    def records_for_contig(self, contig: str) -> "_RecordSeq":
        return _RecordSeq(contig, self._store.get(contig))

    def contig_id(self, contig: str) -> int:
        """bcf_hdr_name2id equivalent: index in header contig order."""
        return self.contigs.index(contig)

    def sample_index(self, sample: str) -> int:
        return self.samples.index(sample)


def merge_vcfs(
    fnames: List[str], contigs: Optional[List[str]] = None,
    store_format: bool = False,
) -> "VCF":
    """Multi-VCF support (the reference's synced reader takes a list;
    tests use one file).  Records are concatenated per contig and re-sorted
    by position; samples must agree or be disjoint per file.  ``contigs``
    restricts every file (index-seek where a .csi/.tbi exists)."""
    base = VCF(fnames[0], contigs=contigs, store_format=store_format)
    if len(fnames) == 1:
        return base
    extras = [VCF(f, contigs=contigs, store_format=store_format)
              for f in fnames[1:]]
    # snapshot each file's OWN sample list before base.samples is extended:
    # pad_gts must index the per-file gts matrix by the per-file layout
    own_samples = {id(v): list(v.samples) for v in [base] + extras}
    for v in extras:
        for c in v.contigs:
            if c not in base.contigs:
                base.contigs.append(c)
        for s in v.samples:
            if s not in base.samples:
                base.samples.append(s)
    nsamples = len(base.samples)
    all_vcfs = [base] + extras

    def pad_gts(v: "VCF", st: _ContigStore) -> np.ndarray:
        """Expand st.gts to the merged sample axis (missing = -1)."""
        out = np.full((len(st), nsamples, 2), -1, dtype=np.int16)
        for j, s in enumerate(own_samples[id(v)]):
            out[:, base.samples.index(s), :] = st.gts[:, j, :]
        return out

    merged: dict = {}
    for c in base.contigs:
        parts = [
            (v, v._store[c]) for v in all_vcfs if c in v._store
        ]
        if not parts:
            continue
        pos = np.concatenate([st.pos for _, st in parts])
        order = np.argsort(pos, kind="stable")
        gts = np.concatenate([pad_gts(v, st) for v, st in parts])[order]
        # rebuild arenas in sorted record order
        alleles: List[bytes] = []
        ids: List[bytes] = []
        quals: List[float] = []
        filters: List[bytes] = []
        infos: List[bytes] = []
        fmts: List[bytes] = []
        cnt_parts = alleles
        for _, st in parts:
            for i in range(len(st)):
                a, b2 = st.allele_cnt[i], st.allele_cnt[i + 1]
                cnt_parts.append(
                    b",".join(
                        st.allele_arena[
                            st.allele_off[j]: st.allele_off[j + 1]
                        ]
                        for j in range(a, b2)
                    )
                )
                ids.append(st.id_arena[st.id_off[i]: st.id_off[i + 1]])
                quals.append(float(st.qual[i]))
                filters.append(st.filter_of(i).encode())
                infos.append(
                    st.info_arena[st.info_off[i]: st.info_off[i + 1]]
                )
                fmts.append(
                    st.fmt_arena[st.fmt_off[i]: st.fmt_off[i + 1]]
                )
        bld = _ContigBuilder()
        bld.pos = pos[order].tolist()
        bld.alleles = [cnt_parts[i] for i in order]
        bld.ids = [ids[i] for i in order]
        bld.quals = [quals[i] for i in order]
        bld.filters = [filters[i] for i in order]
        bld.infos = [infos[i] for i in order]
        if any(fmts):
            bld.fmts = [fmts[i] for i in order]
        bld.gts = []  # gts set directly below
        st = bld.finish(0)
        st.gts = gts
        merged[c] = st
    base._store = merged
    return base
