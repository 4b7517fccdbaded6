"""The port's haplotype scan (vcf/scan.py, io/fasta.write_fai and
fetch_contig, vcf/scan_worker.py) against pfbwtf_tpu's: for every
haplotype of a generated panel the same records and .mps bytes, and the
same files from write_scan_outputs."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pfbwtf_tpu.io.fasta import fetch_contig as jax_fetch
from pfbwtf_tpu.io.fasta import read_fasta_bytes
from pfbwtf_tpu.io.fasta import write_fai as jax_write_fai
from pfbwtf_tpu.vcf.reader import VCF as JaxVCF
from pfbwtf_tpu.vcf.scan import scan_vcf_sample as jax_scan
from pfbwtf_tpu.vcf.scan import write_scan_outputs as jax_write_scan
from pfbwtf_tpu_torch.io.fasta import fetch_contig, write_fai
from pfbwtf_tpu_torch.vcf.reader import VCF
from pfbwtf_tpu_torch.vcf.scan import scan_vcf_sample, write_scan_outputs

from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _panel(tmp_path, exotic_frac, seed):
    rng = np.random.default_rng(seed)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=2500,
                      line_len=60)
    vcf = str(tmp_path / "p.vcf")
    samples = random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=2,
                         density=0.03, indel_frac=0.3,
                         exotic_frac=exotic_frac)
    return fa, vcf, samples


def test_fai_and_fetch_equal_jax(tmp_path):
    fa, _, _ = _panel(tmp_path, 0.0, 80)
    shutil.copy(fa, tmp_path / "jax.fa")
    write_fai(fa)
    jax_write_fai(str(tmp_path / "jax.fa"))
    assert (open(fa + ".fai").read()
            == (tmp_path / "jax.fa.fai").read_text())
    for contig in ("seq0", "seq1"):
        got = fetch_contig(fa, contig)
        assert len(got) == 2500 and got == jax_fetch(fa, contig)


@pytest.mark.parametrize("exotic_frac,ma_wsize", [(0.0, 1), (0.35, 1),
                                                  (0.0, 4)])
def test_scan_equals_jax(tmp_path, exotic_frac, ma_wsize):
    """Each haplotype's records and .mps bytes, the reference scan first;
    with exotic records (symbolic ALTs, breakends, '*', half-calls)."""
    fa, vcf_path, samples = _panel(tmp_path, exotic_frac, 81)
    vcf, jvcf = VCF(vcf_path), JaxVCF(vcf_path)
    tasks = [("", 0, True)] + [(s, h, False) for s in samples for h in (0, 1)]
    nmarkers = 0
    for sample, hap, ref_only in tasks:
        kw = dict(w=10, ma_wsize=ma_wsize, ref_only=ref_only,
                  want_markers=True)
        got = scan_vcf_sample(vcf, fa, sample, hap, **kw)
        want = jax_scan(jvcf, fa, sample, hap, **kw)
        assert [n for n, _ in got.records] == [n for n, _ in want.records]
        for (_, a), (_, b) in zip(got.records, want.records):
            assert np.array_equal(a, b)
        assert got.mps_bytes == want.mps_bytes
        assert got.n(10) == want.n(10)
        nmarkers += len(got.mps_bytes)
    assert nmarkers > 0


def test_write_scan_outputs_equal_jax(tmp_path):
    fa, vcf_path, samples = _panel(tmp_path, 0.0, 82)
    got = scan_vcf_sample(VCF(vcf_path), fa, samples[1], 1)
    want = jax_scan(JaxVCF(vcf_path), fa, samples[1], 1)
    write_scan_outputs(got, str(tmp_path / "port"), 10)
    jax_write_scan(want, str(tmp_path / "jax"), 10)
    exts = [f[len("jax"):] for f in os.listdir(tmp_path)
            if f.startswith("jax.")]
    assert ".fa" in exts and ".mps" in exts
    for ext in exts:
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes()), ext


def test_scan_worker_is_host_only():
    """A scan worker process imports the VCF modules and no torch, so it
    can start no CUDA context."""
    code = ("import sys, pfbwtf_tpu_torch.vcf.scan_worker\n"
            "assert 'torch' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
