"""A phased VCF panel on a random reference: the reference FASTA and the
VCF that vcf_to_bwt reads.

The contigs (the configuration's ``contig_bp``) are uniform random ACGT
at 60 bases a line, and the panel has the configuration's ``samples``.
The VCF places ``int(length * density)`` variant sites per contig at
distinct positions; each is an indel with probability ``indel_frac`` (a
deletion of, or an insertion of, 1 .. max_indel - 1 bases, either with
probability 1/2) and a SNP otherwise, and each of every sample's two haplotypes carries its ALT
with probability ``af``. A site that starts where the last kept site ends
is left out (marker positions would collide after a deletion); a site
inside the last kept one is written and is skipped by the scan. This is
tests/vcf_gen.random_vcf without its exotic records, with chip_smoke.py's
panel model (density 0.003, af 0.25, indel_frac 0.1, max_indel 6).
"""

import os

import numpy as np

BASES = "ACGT"


def _vcf_lines(contigs, rng, nsamples, density, af, indel_frac, max_indel):
    samples = [f"s{i}" for i in range(nsamples)]
    lines = ["##fileformat=VCFv4.2"]
    lines += [f"##contig=<ID={name},length={len(seq)}>"
              for name, seq in contigs]
    lines.append('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">')
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples))
    vid = 0
    for name, seq in contigs:
        n_var = max(1, int(len(seq) * density))
        pool = rng.choice(np.arange(1, len(seq) - max_indel - 2), size=n_var,
                          replace=False)
        prev_end = -1
        for pos in np.sort(pool):
            pos = int(pos)
            if pos == prev_end:
                continue
            ref_base = chr(seq[pos])
            if rng.random() < indel_frac:
                k = int(rng.integers(1, max_indel))
                if rng.random() < 0.5:
                    ref = ref_base + bytes(seq[pos + 1:pos + 1 + k]).decode()
                    alt = ref_base
                else:
                    ref = ref_base
                    alt = ref_base + "".join(rng.choice(list(BASES), size=k))
            else:
                ref = ref_base
                alt = rng.choice([b for b in BASES if b != ref_base])
            gts = []
            for _ in samples:
                h0 = 1 if rng.random() < af else 0
                h1 = 1 if rng.random() < af else 0
                gts.append(f"{h0}|{h1}")
            vid += 1
            lines.append(f"{name}\t{pos + 1}\tv{vid}\t{ref}\t{alt}\t.\tPASS\t."
                         "\tGT\t" + "\t".join(gts))
            if pos >= prev_end:
                prev_end = pos + len(ref)
    return lines


def make(config: dict, traffic: dict, seed: int, workdir: str) -> dict:
    """Write ``ref.fa`` and ``panel.vcf`` under ``workdir``; return their
    paths."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    contigs = [(f"chr{chr(ord('A') + i)}", acgt[rng.integers(0, 4, size=n)])
               for i, n in enumerate(config["contig_bp"])]
    fasta = os.path.join(workdir, "ref.fa")
    with open(fasta, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            body = np.full(-(-seq.size // 60) * 61, ord("\n"), np.uint8)
            rows = body.reshape(-1, 61)
            full = seq.size // 60
            rows[:full, :60] = seq[:full * 60].reshape(full, 60)
            tail = seq.size - full * 60
            if tail:
                rows[full, :tail] = seq[full * 60:]
                body = body[:full * 61 + tail + 1]
            f.write(body.tobytes())
    lines = _vcf_lines([(c, s.tobytes()) for c, s in contigs], rng,
                       int(config["samples"]), float(traffic["density"]),
                       float(traffic["af"]), float(traffic["indel_frac"]),
                       int(traffic["max_indel"]))
    vcf = os.path.join(workdir, "panel.vcf")
    with open(vcf, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"fasta": fasta, "vcf": vcf}
