"""vcf_to_bwt of the port (device="cpu") against the independent
brute-force oracle (tests/oracle.py) on the four fuzz cases of
tests/test_oracle_fuzz.py: BWT, SA and marker lines."""

import numpy as np
import pytest

from pfbwtf_tpu.io.fasta import read_fasta_bytes
from pfbwtf_tpu.markers.dump import readable_markers_lines
from pfbwtf_tpu.vcf.reader import VCF
from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

from .oracle import oracle_outputs
from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf


@pytest.mark.parametrize(
    "seed,ncontigs,length,nsamples,density,indel_frac",
    [
        (101, 1, 3000, 2, 0.01, 0.0),   # SNPs only
        (102, 2, 2000, 2, 0.02, 0.3),   # indels
        (103, 3, 1000, 3, 0.05, 0.5),   # dense, indel-heavy
        (104, 1, 5000, 1, 0.005, 0.2),  # sparse
    ],
)
def test_port_matches_oracle(tmp_path, seed, ncontigs, length, nsamples,
                             density, indel_frac):
    rng = np.random.default_rng(seed)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=ncontigs,
                      length=length)
    vcf_path = str(tmp_path / "p.vcf")
    samples = random_vcf(vcf_path, read_fasta_bytes(fa), rng,
                         nsamples=nsamples, density=density,
                         indel_frac=indel_frac)
    out = str(tmp_path / "out")
    vcf_to_bwt(VcfToBwtConfig(fasta=fa, vcfs=[vcf_path], output=out, sa=True,
                              ma=True, wsize=10, mod=10, ma_wsize=1,
                              device="cpu"))
    big, sa_o, bwt_o, _, marker_lines = oracle_outputs(fa, VCF(vcf_path),
                                                       samples)
    bwt_p = np.fromfile(out + ".bwt", dtype=np.uint8)
    sa_p = np.fromfile(out + ".sa", dtype=np.uint64)
    n = big.shape[0]
    assert bwt_p.shape[0] == n + 1
    assert np.array_equal(bwt_p, bwt_o), "BWT != oracle"
    # the oracle's SA has the empty suffix at index n; the pipeline writes n
    assert int(sa_p[0]) == n
    assert np.array_equal(sa_p[1:].astype(np.int64), sa_o[1:]), "SA != oracle"
    got_lines = list(readable_markers_lines(out + ".ma"))
    assert len(got_lines) > 0 and got_lines == marker_lines
