"""The port's VCF and marker CLIs (vcf_to_bwt, vcf_scan, merge_mps,
mps_to_ma; each ``main(argv, device="cpu")``) write the same files as
pfbwtf_tpu's CLIs."""

import shutil

import numpy as np
import pytest

from pfbwtf_tpu.cli import merge_mps as jax_merge_mps
from pfbwtf_tpu.cli import mps_to_ma as jax_mps_to_ma
from pfbwtf_tpu.cli import vcf_scan as jax_vcf_scan
from pfbwtf_tpu.cli import vcf_to_bwt as jax_vcf_to_bwt
from pfbwtf_tpu.io.fasta import read_fasta_bytes
from pfbwtf_tpu_torch.cli import merge_mps, mps_to_ma, vcf_scan, vcf_to_bwt

from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf

EXTS = ("bwt", "sa", "ssa", "esa", "ma", "mps", "dict", "occ", "parse", "n",
        "docs", "bwlast", "ilist", "bwsai")


def _panel(tmp_path, seed=110):
    rng = np.random.default_rng(seed)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=1800)
    vcf = str(tmp_path / "p.vcf")
    random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=3, density=0.02,
               indel_frac=0.3)
    return fa, vcf


def _assert_same_files(tmp_path, exts=EXTS):
    seen = []
    for ext in exts:
        want = tmp_path / f"jax.{ext}"
        got = tmp_path / f"port.{ext}"
        assert got.exists() == want.exists(), ext
        if want.exists():
            assert got.read_bytes() == want.read_bytes(), ext
            seen.append(ext)
    return seen


@pytest.mark.parametrize("extra", [
    ["-s", "-m", "--keep_parse"],
    ["-s", "-r", "-m", "--fused"],
    ["--u32", "-s", "-r", "--clean", "-m", "--ma_wsize", "2"],
    ["-s", "-m", "--mmap", "--device", "--wsize", "8", "--mod", "13"],
])
def test_vcf_to_bwt_cli_equals_jax(tmp_path, extra):
    """The CLI with a sample file; --device and --mmap are accepted by the
    port and change nothing (pfbwtf_tpu runs without --device here)."""
    fa, vcf = _panel(tmp_path)
    samples = tmp_path / "samples.txt"
    samples.write_text("s1\ns2\n")
    jax_extra = [a for a in extra if a != "--device"]
    for name, main, more, kw in (("jax", jax_vcf_to_bwt.main, jax_extra, {}),
                                 ("port", vcf_to_bwt.main, extra,
                                  {"device": "cpu"})):
        shutil.copy(fa, tmp_path / f"{name}.fa")
        assert main([str(tmp_path / f"{name}.fa"), vcf, "-o",
                     str(tmp_path / name), "-S", str(samples), *more],
                    **kw) == 0
    seen = _assert_same_files(tmp_path)
    assert {"bwt", "sa", "ma", "mps"} <= set(seen)
    assert ("parse" in seen) == ("--keep_parse" in extra
                                 or ("--clean" not in extra
                                     and "--fused" not in extra))


def test_vcf_to_bwt_cli_mesh_exits_1(tmp_path, capsys):
    """vcf_to_bwt --mesh, which exited 1 before the mesh family was
    ported, runs the fused mesh build (a one-rank gloo world in process)
    and writes pfbwtf_tpu's files with its exit code."""
    fa, vcf = _panel(tmp_path)
    args = ["--mesh", "-s", "-r", "-m"]
    codes = []
    for name, main, kw in (("jax", jax_vcf_to_bwt.main, {}),
                           ("port", vcf_to_bwt.main, {"device": "cpu"})):
        shutil.copy(fa, tmp_path / f"{name}.fa")
        codes.append(main([str(tmp_path / f"{name}.fa"), vcf, "-o",
                           str(tmp_path / name), *args], **kw))
    assert codes == [0, 0]
    assert "not ported" not in capsys.readouterr().err
    assert {"bwt", "sa", "ssa", "esa", "ma", "mps"} <= set(
        _assert_same_files(tmp_path))


def _scan_cli(tmp_path, fa, vcf, name, main, args):
    return main(["-f", fa, "-o", str(tmp_path / name), *args, vcf])


@pytest.mark.parametrize("args", [
    ["-r", "-m", "-x", "1"],
    ["-S", "s0,s2", "-H", "1", "-m", "-x", "3"],
    ["-S", "s1", "-H", "0", "-w", "6"],
])
def test_vcf_scan_cli_equals_jax(tmp_path, args):
    fa, vcf = _panel(tmp_path, seed=111)
    for name, main in (("jax", jax_vcf_scan.main), ("port", vcf_scan.main)):
        assert _scan_cli(tmp_path, fa, vcf, name, main, args) == 0
    outs = sorted(p.name[4:] for p in tmp_path.glob("jax.*"))
    assert any(o.endswith(".fa") for o in outs)
    for o in outs:
        assert ((tmp_path / f"port.{o}").read_bytes()
                == (tmp_path / f"jax.{o}").read_bytes()), o


def test_vcf_scan_stdout_equals_jax(tmp_path, capfd):
    fa, vcf = _panel(tmp_path, seed=112)
    outs = []
    for name, main in (("jax", jax_vcf_scan.main), ("port", vcf_scan.main)):
        capfd.readouterr()
        assert _scan_cli(tmp_path, fa, vcf, name, main,
                         ["-S", "s0", "-H", "1", "--stdout", "-m"]) == 0
        outs.append(capfd.readouterr().out)
    assert outs[0].startswith(">s0.1.seq0\n") and outs[1] == outs[0]
    assert ((tmp_path / "port.s0.1.mps").read_bytes()
            == (tmp_path / "jax.s0.1.mps").read_bytes())


def test_merge_mps_and_mps_to_ma_cli_equal_jax(tmp_path):
    """vcf_scan's per-haplotype files merged by merge_mps, then mps_to_ma
    over a .sa of the right length, in both packages."""
    fa, vcf = _panel(tmp_path, seed=113)
    scans = (["-r", "-m"], ["-S", "s0", "-H", "0", "-m"],
             ["-S", "s0", "-H", "1", "-m"])
    for args in scans:
        assert _scan_cli(tmp_path, fa, vcf, "h", jax_vcf_scan.main, args) == 0
    prefixes = [str(tmp_path / p) for p in ("h.ref", "h.s0.0", "h.s0.1")]
    assert merge_mps.main([str(tmp_path / "port.mps"), *prefixes]) == 0
    assert jax_merge_mps.main([str(tmp_path / "jax.mps"), *prefixes]) == 0
    assert merge_mps.main([]) == 1
    n = sum(int(open(p + ".n").read()) for p in prefixes)
    sa = np.random.default_rng(114).permutation(n + 1).astype(np.uint64)
    sa_path = tmp_path / "x.sa"
    sa_path.write_bytes(sa.tobytes())
    assert jax_mps_to_ma.main([str(tmp_path / "jax.mps"), str(sa_path), "-o",
                               str(tmp_path / "jax.ma")]) == 0
    assert mps_to_ma.main([str(tmp_path / "port.mps"), str(sa_path), "-o",
                           str(tmp_path / "port.ma"), "--device"],
                          device="cpu") == 0
    seen = _assert_same_files(tmp_path, ("mps", "ma"))
    assert seen == ["mps", "ma"]
    assert (tmp_path / "port.ma").stat().st_size > 0
