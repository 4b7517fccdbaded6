"""vcf_to_bwt of the port (vcf/pipeline.py, device="cpu") against
pfbwtf_tpu's on generated panels: every file of the run byte for byte,
staged and fused."""

import os
import shutil

import numpy as np
import pytest

from pfbwtf_tpu.io.fasta import read_fasta_bytes
from pfbwtf_tpu.vcf.pipeline import VcfToBwtConfig as JaxConfig
from pfbwtf_tpu.vcf.pipeline import vcf_to_bwt as jax_vcf_to_bwt
from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf

# every file a vcf_to_bwt run may write beside its prefix
EXTS = ("bwt", "sa", "ssa", "esa", "ma", "mps", "dict", "occ", "parse", "n",
        "docs", "bwlast", "ilist", "bwsai")


def _panel(tmp_path, seed=90, nsamples=3, split=False):
    """A reference of two contigs and a phased panel on it; with
    ``split`` the records go to two VCFs by parity."""
    rng = np.random.default_rng(seed)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=2000)
    vcf = str(tmp_path / "p.vcf")
    random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=nsamples,
               density=0.02, indel_frac=0.3)
    if not split:
        return fa, [vcf]
    lines = open(vcf).read().splitlines()
    header = [l for l in lines if l.startswith("#")]
    recs = [l for l in lines if not l.startswith("#")]
    parts = []
    for i, part in enumerate((recs[0::2], recs[1::2])):
        parts.append(str(tmp_path / f"part{i}.vcf"))
        with open(parts[-1], "w") as f:
            f.write("\n".join(header + list(part)) + "\n")
    return fa, parts


def _run_both(tmp_path, fa, vcfs, **kw):
    """Both pipelines on copies of the FASTA (write_fai writes beside it);
    returns the file extensions pfbwtf_tpu wrote."""
    for name in ("jax", "port"):
        shutil.copy(fa, tmp_path / f"{name}.fa")
    jax_vcf_to_bwt(JaxConfig(fasta=str(tmp_path / "jax.fa"), vcfs=vcfs,
                             output=str(tmp_path / "jax"), mod=10, **kw))
    vcf_to_bwt(VcfToBwtConfig(fasta=str(tmp_path / "port.fa"), vcfs=vcfs,
                              output=str(tmp_path / "port"), mod=10,
                              device="cpu", **kw))
    exts = [e for e in EXTS if (tmp_path / f"jax.{e}").exists()]
    for ext in EXTS:
        assert ((tmp_path / f"port.{ext}").exists()
                == (tmp_path / f"jax.{ext}").exists()), ext
    for ext in exts:
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert got == (tmp_path / f"jax.{ext}").read_bytes(), ext
    return exts


STAGED = {
    "ma_sa_rssa": dict(ma=True, sa=True, rssa=True),
    "no_ma": dict(ma=False, sa=True),
    "no_keep_parse": dict(ma=True, sa=True, keep_parse=False),
    "u32": dict(ma=True, sa=True, rssa=True, dtype=np.dtype("<u4")),
    "contigs": dict(ma=True, sa=True, contigs=["seq1"]),
    "ma_wsize_3": dict(ma=True, sa=True, ma_wsize=3),
    "bwt_only": dict(),
}


@pytest.mark.parametrize("case", list(STAGED))
def test_staged_equals_jax(tmp_path, case):
    fa, vcfs = _panel(tmp_path)
    exts = _run_both(tmp_path, fa, vcfs, **STAGED[case])
    assert "bwt" in exts
    assert ("ma" in exts) == STAGED[case].get("ma", False)
    assert ("parse" in exts) == STAGED[case].get("keep_parse", True)


def test_staged_save_fasta_and_samples_equal_jax(tmp_path):
    """save_fasta writes each haplotype's FASTA (and .mps, .n) beside the
    prefix; a sample subset scans only those samples."""
    fa, vcfs = _panel(tmp_path, seed=91)
    _run_both(tmp_path, fa, vcfs, ma=True, sa=True, save_fasta=True,
              samples=["s2", "s0"])
    names = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("jax.") and f.count(".") >= 2)
    assert any(f.startswith("jax.s2.1.") for f in names)
    assert not any(f.startswith("jax.s1.") for f in names)
    for f in names:
        if f.endswith(".log"):
            continue
        assert ((tmp_path / ("port" + f[3:])).read_bytes()
                == (tmp_path / f).read_bytes()), f


def test_staged_two_vcfs_equal_jax_and_one_vcf(tmp_path):
    fa, parts = _panel(tmp_path, seed=92, split=True)
    _run_both(tmp_path, fa, parts, ma=True, sa=True)
    shutil.copy(fa, tmp_path / "one.fa")
    vcf_to_bwt(VcfToBwtConfig(fasta=str(tmp_path / "one.fa"),
                              vcfs=[str(tmp_path / "p.vcf")],
                              output=str(tmp_path / "one"), mod=10, ma=True,
                              sa=True, device="cpu"))
    for ext in ("bwt", "sa", "ma", "mps"):
        assert ((tmp_path / f"one.{ext}").read_bytes()
                == (tmp_path / f"port.{ext}").read_bytes()), ext


@pytest.mark.parametrize("kw", [dict(ma=True, sa=True, rssa=True),
                                dict(ma=True, dtype=np.dtype("<u4"))],
                         ids=["ma_sa_rssa", "ma_u32"])
def test_fused_equals_jax(tmp_path, kw):
    """--fused: .bwt/.sa/.ssa/.esa/.ma/.mps, and no checkpoint files."""
    fa, vcfs = _panel(tmp_path, seed=93, nsamples=2)
    exts = _run_both(tmp_path, fa, vcfs, fused=True, **kw)
    assert "ma" in exts and "parse" not in exts


def test_threads_equal_serial(tmp_path):
    """--threads 2 runs the scans in worker processes: the same files as
    the serial run, and a .log for each scan."""
    fa, vcfs = _panel(tmp_path, seed=94)
    outs = {}
    for threads in (1, 2):
        name = f"t{threads}"
        shutil.copy(fa, tmp_path / f"{name}.fa")
        outs[threads] = str(tmp_path / name)
        vcf_to_bwt(VcfToBwtConfig(fasta=str(tmp_path / f"{name}.fa"),
                                  vcfs=vcfs, output=outs[threads], mod=10,
                                  ma=True, sa=True, rssa=True,
                                  threads=threads, device="cpu"))
    for ext in EXTS:
        with open(f"{outs[1]}.{ext}", "rb") as f:
            want = f.read()
        with open(f"{outs[2]}.{ext}", "rb") as f:
            assert f.read() == want, ext
    log = open(outs[2] + ".ref.log").read()
    assert "pfbwtf_tpu_torch.vcf.scan_worker" in log
    assert "done: n=" in open(outs[2] + ".log").read()


def test_mesh_is_not_ported(tmp_path):
    """cfg.mesh, which raised "not ported" before the mesh family was
    ported, runs the fused mesh build (a one-rank gloo world, gone after
    the call) and writes every file of pfbwtf_tpu's mesh run."""
    import torch.distributed as dist

    fa, vcfs = _panel(tmp_path, seed=95)
    exts = _run_both(tmp_path, fa, vcfs, mesh=True, ma=True, sa=True,
                     rssa=True)
    assert not dist.is_initialized()
    assert {"bwt", "sa", "ssa", "esa", "ma", "mps"} <= set(exts)
