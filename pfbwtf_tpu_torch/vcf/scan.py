"""Haplotype materialization + marker emission (vcf_scan equivalent).

Reproduces scan_vcf_sample (src/vcf_scan.cpp:127-235): for each VCF-header
contig, walk records left-to-right, emit ref slice + chosen allele, track
indel bias, and stream marker positions into a MarkerPositionsWriter.
Marker placement rules (vcf_scan.cpp:180-202; validated against the
independent-oracle truth logic in scripts/generate_truth_set.py:56-80):

  SNP  (rlen==1==alen):          mark pos
  gt==0 indel (rlen!=alen):      mark pos..pos+rlen (inclusive), no bias
  deletion (rlen>alen, gt>0):    mark pos, pos+1;       bias -= rlen-1
  insertion (rlen<alen, gt>0):   mark pos..pos+alen;    bias += alen-1

where rlen/alen are len(REF)/len(ALT1) — ALT1 regardless of gt, preserving
the reference's quirk — and marked positions are seq_start + bias + ... in
haplotype text coordinates.  Overlapping records are skipped with a warning
(vcf_scan.cpp:210-213).
"""

import io
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..io.fasta import fetch_contig
from ..markers.mps import BatchMarkerPositionsWriter
from .reader import VCF


@dataclass
class ConsensusOpts:
    """bcftools-consensus-style sequence transforms (consensus.cpp:469-507,
    1105-1130).  Case marks are length-preserving; mark_del / missing /
    absent change emission lengths and are therefore rejected when marker
    emission is on (the reference tracks them through its own bias logic;
    here consensus mode and marker mode are exclusive for those)."""

    mark_del: str = ""  # CHAR emitted in place of deleted bases
    mark_ins: str = ""  # 'uc'|'lc': case of inserted bases
    mark_snv: str = ""  # 'uc'|'lc': case of substituted bases
    absent: str = ""  # CHAR for positions absent from the VCF
    missing: str = ""  # CHAR applied for missing genotypes ./.
    prefix: str = ""  # prepended to output sequence names
    mask: dict = field(default_factory=dict)  # contig -> [(start, end)) BED
    mask_with: str = "N"  # CHAR | 'uc' | 'lc'
    chain: bool = False  # -c: record UCSC liftover chains per contig
    site_filter: object = None  # compiled -i/-e expression (vcf/filter.py)
    filter_exclude: bool = False  # True: -e semantics (drop matching sites)

    def length_changing(self) -> bool:
        return bool(self.mark_del or self.absent or self.missing
                    or (self.mask and self.mask_with not in ("uc", "lc")))


def _case_seg(seg: bytes, how: str) -> bytes:
    return seg.lower() if how == "lc" else seg.upper()


def _is_sequence_allele(a: str) -> bool:
    """True iff the allele string is literal sequence that can be spliced
    into the haplotype.  Symbolic ALTs (<DEL>, <INS>, <CN0>, ...),
    breakends (containing [ or ]), single breakends (leading/trailing '.')
    and the '*' spanning-deletion allele carry no splice-able bases — the
    reference inherits their representation from htslib
    (vcf_scanner.hpp:9-13) and real 1000G-derived panels contain them, so
    they must parse cleanly; records selecting them are skipped with a
    warning (the overlap-skip philosophy, vcf_scan.cpp:210-213)."""
    if not a or a == "*":
        return False
    if a[0] == "<" or "[" in a or "]" in a:
        return False
    if a[0] == "." or a[-1] == ".":
        return False
    return True


def _apply_mask(ref_seq: bytes, regions, mask_with: str):
    """Returns (masked ref, list of char-masked regions to skip variants
    in).  BED semantics: 0-based half-open."""
    buf = bytearray(ref_seq)
    skip = []
    for s, e in regions:
        s = max(0, int(s))
        e = min(len(buf), int(e))
        if e <= s:
            continue
        if mask_with in ("uc", "lc"):
            buf[s:e] = _case_seg(bytes(buf[s:e]), mask_with)
        else:
            buf[s:e] = mask_with.encode() * (e - s)
            skip.append((s, e))
    return bytes(buf), skip


def _consensus_allele(copts: "ConsensusOpts", ref_b: bytes, alt_b: bytes,
                      gt: int, gt_missing: bool) -> bytes:
    """Emission transform per applied allele (consensus.cpp:469-507,
    :851-881).  mark_del pads the emission back to REF length; case marks
    touch only the substituted/inserted bases."""
    if gt_missing:
        return copts.missing.encode() if copts.missing else alt_b
    if gt == 0:
        return alt_b
    out = bytearray(alt_b)
    if copts.mark_snv:
        n = min(len(ref_b), len(out))
        for i in range(n):
            if ref_b[i: i + 1].lower() != bytes(out[i: i + 1]).lower():
                out[i: i + 1] = _case_seg(bytes(out[i: i + 1]),
                                          copts.mark_snv)
    if copts.mark_ins and len(out) > len(ref_b):
        out[len(ref_b):] = _case_seg(bytes(out[len(ref_b):]),
                                     copts.mark_ins)
    if copts.mark_del and len(out) < len(ref_b):
        out += copts.mark_del.encode() * (len(ref_b) - len(out))
    return bytes(out)


def read_mask_bed(path: str) -> dict:
    """contig -> [(start, end)) from a BED file (-m FILE)."""
    regions: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split()
            regions.setdefault(parts[0], []).append(
                (int(parts[1]), int(parts[2]))
            )
    return regions


class _ChainBuilder:
    """UCSC liftover chain per contig (consensus.cpp:144-260 semantics):
    ungapped blocks between applied length-changing variants; back-to-back
    variants merge into the previous block's gaps."""

    def __init__(self, ori_pos: int = 0):
        self.ori = ori_pos
        self.blocks: List[int] = []
        self.ref_gaps: List[int] = []
        self.alt_gaps: List[int] = []
        self.ref_last = ori_pos
        self.alt_last = ori_pos
        self.chain_id = 0

    def push(self, ref_start, ref_len, alt_start, alt_len):
        if self.blocks and ref_start <= self.ref_last:
            # back-to-back with the previous variant
            self.ref_last = ref_start + ref_len
            self.alt_last = alt_start + alt_len
            self.ref_gaps[-1] += ref_len
            self.alt_gaps[-1] += alt_len
        else:
            self.blocks.append(ref_start - self.ref_last)
            self.ref_gaps.append(ref_len)
            self.alt_gaps.append(alt_len)
            self.ref_last = ref_start + ref_len
            self.alt_last = alt_start + alt_len

    def render(self, chrom: str, fa_length: int, chain_id: int) -> str:
        ref_end = fa_length + self.ori
        last_block = ref_end - self.ref_last
        alt_end = self.alt_last + last_block
        score = sum(self.blocks) + last_block
        lines = [
            f"chain {score} {chrom} {ref_end} + {self.ori} {ref_end} "
            f"{chrom} {alt_end} + {self.ori} {alt_end} {chain_id}"
        ]
        for b, rg, ag in zip(self.blocks, self.ref_gaps, self.alt_gaps):
            lines.append(f"{b} {rg} {ag}")
        lines.append(f"{last_block}")
        lines.append("")
        return "\n".join(lines) + "\n"


@dataclass
class ScanResult:
    records: List[Tuple[str, np.ndarray]] = field(default_factory=list)
    mps_bytes: bytes = b""
    chain_text: str = ""  # -c: concatenated per-contig chain records

    def n(self, w: int) -> int:
        """Parse-time text length of this haplotype fasta (sum of contig
        lengths + w pad each) — what its .n checkpoint file holds."""
        return sum(len(s) + w for _, s in self.records)


def scan_vcf_sample(
    vcf: VCF,
    ref_fasta: str,
    sample: str,
    haplotype: int,
    w: int = 10,
    ma_wsize: int = 1,
    ref_only: bool = False,
    want_markers: bool = True,
    contigs: Optional[List[str]] = None,
    copts: Optional[ConsensusOpts] = None,
) -> ScanResult:
    if copts is not None and want_markers and copts.length_changing():
        raise ValueError(
            "length-changing consensus options (--mark-del, --absent, "
            "--missing, char --mask-with) cannot be combined with marker "
            "emission"
        )
    mps_buf = io.BytesIO()
    writer = (
        BatchMarkerPositionsWriter(ma_wsize, mps_buf) if want_markers else None
    )
    out = ScanResult()
    seq_start = 0
    chain_id = 0  # auto-increment across contigs (consensus.cpp:210)
    sample_idx = vcf.sample_index(sample) if not ref_only else -1
    contig_list = contigs if contigs else vcf.contigs
    for contig in contig_list:
        rid = vcf.contig_id(contig)
        try:
            ref_seq = fetch_contig(ref_fasta, contig)
        except KeyError:
            print(
                f"contig {contig} does not exist in fasta, skipping...",
                file=sys.stderr,
            )
            continue
        ref_len = len(ref_seq)
        masked_skip: List[Tuple[int, int]] = []
        if copts is not None and contig in copts.mask:
            ref_seq, masked_skip = _apply_mask(
                ref_seq, copts.mask[contig], copts.mask_with
            )
        header = contig if ref_only else f"{sample}.{haplotype}.{contig}"
        if copts is not None and copts.prefix:
            header = copts.prefix + header
        pieces: List[bytes] = []
        ppos_after = 0
        bias = 0
        prange = (0, 0)
        chain = (
            _ChainBuilder(0)
            if copts is not None and copts.chain
            else None
        )
        chain_off = 0  # cumulative alt-ref length offset (fa_mod_off role)
        for rec in vcf.records_for_contig(contig):
            if copts is not None and copts.site_filter is not None:
                ok = bool(copts.site_filter(rec))
                if copts.filter_exclude:
                    ok = not ok
                if not ok:
                    continue  # filtered at read time (consensus.cpp:397-401)
            rlen = len(rec.alleles[0])
            r0, r1 = rec.pos, rec.pos + rlen
            if not (prange[1] <= r0):
                print(
                    f"Warning: skipping overlapping variant {rid}:{rec.pos} "
                    f"({rec.vid}).",
                    file=sys.stderr,
                )
                continue
            if masked_skip and any(
                s < r1 and r0 < e for s, e in masked_skip
            ):
                continue  # char-masked region: variant not applied
            if ref_only:
                gt = 0
                gt_missing = False
            else:
                gt = rec.gts[sample_idx][haplotype] if rec.gts else -1
                gt_missing = gt == -1
                if gt == -1:
                    gt = 0
            if gt >= rec.n_allele:
                raise ValueError(
                    f"malformed GT in VCF (GT {gt} for record with "
                    f"{rec.n_allele} alleles)"
                )
            # symbolic / breakend / spanning-deletion alleles: no literal
            # sequence to splice, and no meaningful ALT1 length for the
            # marker rules — parse-and-skip with a warning, regardless of
            # marker mode so both modes see identical overlap windows.
            # Half-calls (./0) already fold to the ref allele above
            # (gt -1 -> 0).
            alt1 = rec.alleles[1] if len(rec.alleles) > 1 else ""
            nonseq = (
                (gt > 0 and not _is_sequence_allele(rec.alleles[gt]))
                or (alt1 and not _is_sequence_allele(alt1))
            )
            if nonseq:
                print(
                    f"Warning: skipping non-sequence allele at "
                    f"{rid}:{rec.pos} ({rec.vid}): "
                    f"{rec.alleles[gt] if gt > 0 else alt1!r}",
                    file=sys.stderr,
                )
                continue
            if writer is not None and len(rec.alleles) > 1:
                alen = len(rec.alleles[1])  # ALT1 regardless of gt (quirk)
                base = seq_start + bias + rec.pos
                if rlen == 1 and alen == 1:
                    writer.update(base, rec.pos, gt, rid)
                elif rlen != alen and gt == 0:
                    for i in range(rlen + 1):
                        writer.update(base + i, rec.pos, gt, rid)
                elif rlen > alen and gt > 0:  # deletion
                    writer.update(base, rec.pos, gt, rid)
                    writer.update(base + 1, rec.pos, gt, rid)
                    bias -= rlen - 1
                elif rlen < alen and gt > 0:  # insertion
                    for i in range(alen + 1):
                        writer.update(base + i, rec.pos, gt, rid)
                    bias += alen - 1
            # sequence: ref slice up to the record, then the chosen allele
            gap = ref_seq[ppos_after : rec.pos]
            if copts is not None and copts.absent:
                gap = copts.absent.encode() * len(gap)
            pieces.append(gap)
            allele_b = rec.alleles[gt].encode()
            if copts is not None:
                allele_b = _consensus_allele(
                    copts, rec.alleles[0].encode(), allele_b, gt, gt_missing
                )
            pieces.append(allele_b)
            if chain is not None:
                alen = len(allele_b)
                if alen != rlen:
                    ref_b = rec.alleles[0].encode()
                    # indels usually share the leading base: extend the
                    # ungapped block by 1 (consensus.cpp:921-933)
                    if (
                        ref_b[:1].lower() == allele_b[:1].lower()
                        and rlen >= 1
                        and alen >= 1
                    ):
                        chain.push(rec.pos + 1, rlen - 1,
                                   rec.pos + 1 + chain_off, alen - 1)
                    else:
                        chain.push(rec.pos, rlen, rec.pos + chain_off, alen)
                chain_off += alen - rlen
            ppos_after = rec.pos + rlen
            prange = (r0, r1)
        tail = ref_seq[ppos_after:ref_len]
        if copts is not None and copts.absent:
            tail = copts.absent.encode() * len(tail)
        pieces.append(tail)
        if writer is not None:
            writer.finish_sequence()
        seq = np.frombuffer(b"".join(pieces), dtype=np.uint8)
        out.records.append((header, seq))
        if chain is not None:
            chain_id += 1
            out.chain_text += chain.render(contig, ref_len, chain_id)
        seq_start += ref_len + w + bias
    out.mps_bytes = mps_buf.getvalue() if writer is not None else b""
    return out


def write_scan_outputs(result: ScanResult, prefix: str, w: int):
    """Persist a scan like the vcf_scan CLI does: .fa + .mps + .n."""
    from ..io.formats import write_n

    with open(prefix + ".fa", "w") as f:
        for name, seq in result.records:
            f.write(f">{name}\n")
            f.write(seq.tobytes().decode("ascii") + "\n")
    with open(prefix + ".mps", "wb") as f:
        f.write(result.mps_bytes)
    write_n(prefix + ".n", result.n(w))
