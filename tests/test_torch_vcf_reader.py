"""The port's VCF/BCF reader (vcf/reader.py, vcf/index.py) against
pfbwtf_tpu's: the same contigs, samples and columnar records from a
plain VCF, a gzip VCF and a BCF of one generated panel, and the same
merged stream from two files."""

import gzip

import numpy as np
import pytest

from pfbwtf_tpu.vcf.reader import VCF as JaxVCF
from pfbwtf_tpu.vcf.reader import merge_vcfs as jax_merge
from pfbwtf_tpu_torch.vcf.reader import VCF, merge_vcfs

from .test_bcf import vcf_text_to_bcf
from .vcf_gen import random_vcf


def _panel(tmp_path, exotic_frac=0.0, seed=70):
    rng = np.random.default_rng(seed)
    contigs = [(f"c{i}", bytes(rng.choice(list(b"ACGT"), size=n)
                               .astype(np.uint8)))
               for i, n in enumerate((1500, 900))]
    path = str(tmp_path / "p.vcf")
    random_vcf(path, contigs, rng, nsamples=3, density=0.05, indel_frac=0.3,
               exotic_frac=exotic_frac)
    return path


def _rows(vcf):
    out = []
    for c in vcf.contigs:
        for r in vcf.records_for_contig(c):
            out.append((r.contig, r.pos, r.vid, tuple(r.alleles), r.filter,
                        r.info, None if np.isnan(r.qual) else r.qual,
                        r.gts._row.tolist()))
    return out


def _assert_same(got, want):
    assert got.contigs == want.contigs
    assert got.samples == want.samples
    for c in want.contigs:
        assert got.n_records(c) == want.n_records(c)
        assert got.contig_id(c) == want.contig_id(c)
    rows = _rows(want)
    assert len(rows) > 20 and _rows(got) == rows


@pytest.mark.parametrize("fmt", ["vcf", "vcf.gz", "bcf"])
def test_reader_equals_jax(tmp_path, fmt):
    path = _panel(tmp_path)
    if fmt == "vcf.gz":
        with open(path, "rb") as f:
            data = f.read()
        path += ".gz"
        with open(path, "wb") as f:
            f.write(gzip.compress(data))
    elif fmt == "bcf":
        vcf_text_to_bcf(path, path[:-4] + ".bcf")
        path = path[:-4] + ".bcf"
    _assert_same(VCF(path), JaxVCF(path))


def test_reader_exotic_records_equal_jax(tmp_path):
    """Symbolic ALTs, breakends, '*' alleles, half-calls and missing GTs."""
    path = _panel(tmp_path, exotic_frac=0.35, seed=71)
    _assert_same(VCF(path), JaxVCF(path))


@pytest.mark.parametrize("contigs", [None, ["c1"]])
def test_merge_vcfs_equals_jax(tmp_path, contigs):
    """Two VCFs (the records split by parity) merge into one stream, with
    and without a contig subset."""
    path = _panel(tmp_path, seed=72)
    lines = open(path).read().splitlines()
    header = [l for l in lines if l.startswith("#")]
    recs = [l for l in lines if not l.startswith("#")]
    parts = []
    for i, part in enumerate((recs[0::2], recs[1::2])):
        parts.append(str(tmp_path / f"part{i}.vcf"))
        with open(parts[-1], "w") as f:
            f.write("\n".join(header + list(part)) + "\n")
    got = merge_vcfs(parts, contigs=contigs)
    _assert_same(got, jax_merge(parts, contigs=contigs))
    assert _rows(got) == _rows(merge_vcfs([path], contigs=contigs))
