"""A phased VCF panel on a reference FASTA: the haplotype texts, the
merged marker positions (.mps) and the marker array (.ma).

What vcf_to_bwt builds, worked out plainly (vcf_scan and merge_mps of
pfbwt-f, marker window 1):

- Haplotypes come in the order reference, then each sample's haplotype 0
  and 1. Each is every contig of the VCF header (that the FASTA holds), in
  header order, with each record's chosen allele in place of its REF. A
  record that starts before the end of the last applied one is skipped.
- Each applied record with an ALT marks text positions of its haplotype
  with the marker (allele << 60 | contig id << 46 | 0-based position).
  With rlen = len(REF), alen = len(ALT1) and base = the contig's start in
  the haplotype + the indel bias so far + the record's position: a SNP
  marks base; an indel with allele 0 marks base .. base + rlen; a
  deletion taken marks base and base + 1 and the bias falls by rlen - 1;
  an insertion taken marks base .. base + alen and the bias rises by
  alen - 1. A contig advances the haplotype's start by its reference
  length + w + its bias.
- The .mps holds, per haplotype and contig, each maximal run of adjacent
  marked positions with one marker, as uint64 (start, end, marker,
  0xFFFFFFFFFFFFFFFF), shifted by the text length of the haplotypes
  before it (their lengths + w per contig).
- The .ma holds the same for SA rows: each maximal run of adjacent rows
  whose suffixes start at positions with one marker.
"""

import numpy as np
import torch

DELIM = np.uint64(0xFFFFFFFFFFFFFFFF)


def read_vcf(path: str):
    """(contig names in header order, sample names, records by contig).

    A record is (0-based position, alleles, genotypes as an int array of
    shape (samples, 2)). Only literal-sequence alleles and phased integer
    genotypes are read: the panel generator writes nothing else."""
    contigs, samples, recs = [], [], {}
    with open(path) as f:
        for line in f:
            if line.startswith("##contig=<ID="):
                contigs.append(line[len("##contig=<ID="):].split(",")[0]
                               .rstrip(">\n"))
            elif line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
            elif line and not line.startswith("#"):
                cols = line.rstrip("\n").split("\t")
                alleles = [cols[3]] + cols[4].split(",")
                gts = np.array([[int(a) for a in g.split("|")]
                                for g in cols[9:]], dtype=np.int64)
                recs.setdefault(cols[0], []).append(
                    (int(cols[1]) - 1, alleles, gts))
    return contigs, samples, recs


def marker(pos: int, allele: int, contig_id: int) -> int:
    return ((allele & 0xF) << 60) | ((contig_id & 0xFFFF) << 46) | (
        pos & ((1 << 44) - 1))


def haplotype(ref_seqs: dict, contigs, recs, sample: int, hap: int, w: int):
    """One haplotype: (its contig sequences, marked text positions, their
    markers). ``sample`` -1 is the reference itself (allele 0 everywhere)."""
    seqs, pos, val = [], [], []
    start = 0
    for cid, contig in enumerate(contigs):
        if contig not in ref_seqs:
            continue
        ref = ref_seqs[contig]
        pieces, after, last_end, bias = [], 0, 0, 0
        for rpos, alleles, gts in recs.get(contig, ()):
            rlen = len(alleles[0])
            if rpos < last_end:
                continue
            gt = 0 if sample < 0 else int(gts[sample, hap])
            if len(alleles) > 1:
                alen = len(alleles[1])
                base = start + bias + rpos
                m = marker(rpos, gt, cid)
                if rlen == 1 and alen == 1:
                    marks = [base]
                elif rlen != alen and gt == 0:
                    marks = range(base, base + rlen + 1)
                elif rlen > alen:
                    marks = [base, base + 1]
                    bias -= rlen - 1
                elif rlen < alen:
                    marks = range(base, base + alen + 1)
                    bias += alen - 1
                else:
                    marks = []
                pos += list(marks)
                val += [m] * len(marks)
            pieces += [ref[after:rpos], alleles[gt].encode()]
            after = last_end = rpos + rlen
        pieces.append(ref[after:])
        seqs.append(np.frombuffer(b"".join(pieces), dtype=np.uint8))
        start += len(ref) + w + bias
    return seqs, pos, val


def runs(pos: np.ndarray, val: np.ndarray):
    """Maximal runs of adjacent positions with one value:
    (starts, ends, values)."""
    if pos.shape[0] == 0:
        return pos, pos, val
    new = np.ones(pos.shape[0], dtype=bool)
    new[1:] = (pos[1:] != pos[:-1] + 1) | (val[1:] != val[:-1])
    heads = np.flatnonzero(new)
    ends = np.concatenate((heads[1:] - 1, [pos.shape[0] - 1]))
    return pos[heads], pos[ends], val[heads]


def run_stream(starts, ends, vals) -> np.ndarray:
    """The uint64 words of an .mps/.ma file with one marker a run."""
    out = np.empty((starts.shape[0], 4), dtype=np.uint64)
    out[:, 0], out[:, 1], out[:, 2], out[:, 3] = starts, ends, vals, DELIM
    return out.reshape(-1)


def panel(fasta_records, vcf_path: str, w: int):
    """(haplotype records in build order, marked text positions of the
    whole collection, their markers as int64, the .mps words)."""
    ref_seqs = {name: seq.tobytes() for name, seq in fasta_records}
    contigs, samples, recs = read_vcf(vcf_path)
    order = [(-1, 0)] + [(s, h) for s in range(len(samples)) for h in (0, 1)]
    seqs, pos_all, val_all, mps = [], [], [], []
    offset = 0
    for s, h in order:
        hs, pos, val = haplotype(ref_seqs, contigs, recs, s, h, w)
        pos = np.asarray(pos, dtype=np.int64) + offset
        val = np.asarray(val, dtype=np.int64)
        mps.append(run_stream(*runs(pos, val)))
        pos_all.append(pos)
        val_all.append(val)
        seqs += hs
        offset += sum(len(x) + w for x in hs)
    return (seqs, np.concatenate(pos_all), np.concatenate(val_all),
            np.concatenate(mps))


def marker_array(sa: torch.Tensor, pos: np.ndarray, val: np.ndarray):
    """The .ma words: runs of adjacent SA rows whose suffixes start at
    positions with one marker."""
    at = torch.full((sa.shape[0],), -1, dtype=torch.int64, device=sa.device)
    at[torch.from_numpy(pos).to(sa.device)] = torch.from_numpy(val).to(
        sa.device)
    row_val = at[sa]
    del at
    rows = torch.nonzero(row_val >= 0).flatten()
    vals = row_val[rows]
    del row_val
    new = torch.ones(rows.shape[0], dtype=torch.bool, device=sa.device)
    new[1:] = (rows[1:] != rows[:-1] + 1) | (vals[1:] != vals[:-1])
    heads = torch.nonzero(new).flatten()
    last = torch.cat((heads[1:] - 1, heads.new_tensor([rows.shape[0] - 1])))
    if rows.shape[0] == 0:
        heads = last = heads[:0]
    return run_stream(rows[heads].cpu().numpy(), rows[last].cpu().numpy(),
                      vals[heads].cpu().numpy())
