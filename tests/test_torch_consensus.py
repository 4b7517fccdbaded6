"""The port's consensus CLI and its -i/-e expression compiler
(vcf/filter.py) against pfbwtf_tpu's: truth values over the records of a
generated panel, and the CLI's FASTA, -x .mps, -c chain, stdout bytes
and exit codes.  Exact equality throughout."""

import shutil

import numpy as np
import pytest

from pfbwtf_tpu.cli import consensus as jax_consensus
from pfbwtf_tpu.io.fasta import read_fasta_bytes
from pfbwtf_tpu.utils.errors import PfbwtError as JaxPfbwtError
from pfbwtf_tpu.vcf import filter as jax_filter
from pfbwtf_tpu.vcf import reader as jax_reader
from pfbwtf_tpu_torch.cli import consensus, vcf_scan
from pfbwtf_tpu_torch.utils.errors import PfbwtError
from pfbwtf_tpu_torch.vcf import filter as port_filter
from pfbwtf_tpu_torch.vcf import reader as port_reader

from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf

FILTERS = ("LowQual", "q10", "PASS", "LowQual;SnpCluster", ".")


def _decorate(vcf: str, rng):
    """Give the generated records QUAL, FILTER, ID, INFO and FORMAT
    DP/AD values drawn from ``rng`` (tests/vcf_gen writes '.' there)."""
    out = []
    for line in open(vcf).read().splitlines():
        if line.startswith("#"):
            out.append(line)
            continue
        f = line.split("\t")
        f[2] = (f"rs{rng.integers(1, 20)}" if rng.random() < 0.5 else f[2])
        f[5] = "." if rng.random() < 0.1 else str(int(rng.integers(0, 100)))
        f[6] = str(rng.choice(FILTERS))
        info = [f"DP={rng.integers(0, 30)}",
                f"AF={rng.random():.2f},{rng.random():.2f}",
                f"AD={rng.integers(0, 12)},{rng.integers(0, 12)}"]
        if rng.random() < 0.3:
            info.append("DB")
        if rng.random() < 0.3:
            info.append(f"SVTYPE={rng.choice(['DEL', 'DUP', 'INV'])}")
        f[7] = ";".join(info) if rng.random() < 0.9 else "."
        f[8] = "GT:DP:AD"
        f[9:] = [f"{g}:{rng.integers(0, 40)}:{rng.integers(0, 20)},"
                 f"{rng.integers(0, 20)}" for g in f[9:]]
        out.append("\t".join(f))
    with open(vcf, "w") as fh:
        fh.write("\n".join(out) + "\n")


def _panel(tmp_path, seed=5, nsamples=3, decorate=True):
    rng = np.random.default_rng(seed)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=3000)
    vcf = str(tmp_path / "p.vcf")
    samples = random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=nsamples,
                         density=0.02, indel_frac=0.3)
    if decorate:
        _decorate(vcf, rng)
    return fa, vcf, samples


EXPRS = [
    'TYPE="snp"', 'TYPE!="indel"', 'QUAL>30 && FILTER="PASS"',
    'POS<=10 || TYPE="indel"', '!(REF="A")', "INFO/DP>10", "DP<=3",
    'INFO/SVTYPE="DEL"', "DB", "DB=1", "AF>0.4", 'GT="het"', 'GT="hom"',
    'GT="mis"', 'FMT/GT="0|1"', 'GT="alt"',
    'TYPE="snp" && INFO/DP>=10 && GT="het"', "QUAL/2 > 20",
    "QUAL-45 >= 5 && QUAL*2 == 100", "DP-5 > 0", "INFO/AF*100 >= 50",
    "MAX(INFO/AD) > 9", "MIN(INFO/AD) > 9", "SUM(AD) == 13",
    "AVG(AD) == 6.5", "COUNT(AD) == 2", "ABS(ILEN) == 2",
    "STRLEN(REF) == 3", "DP+1 > 0", "-QUAL < -40",
    "N_ALT == 1 && N_SAMPLES == 3", "(QUAL+10)/2 == 30", "FMT/DP > 30",
    "MAX(FMT/AD) >= 16 && FMT/DP >= 7", 'FMT/GT = "0|1"',
    'REF~"^A[CG]$"', 'ID~"^rs[0-9]+"', 'ID!~"^rs"', 'FILTER~"LowQual"',
    'INFO/SVTYPE~"DEL|DUP"', 'INFO/SVTYPE!~"DEL"', "ID=@{ids}",
    "ID!=@{ids}", 'ID=@{ids} && TYPE="snp"',
]


@pytest.fixture(scope="module")
def panel_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("filter_panel")
    _, vcf, _ = _panel(tmp)
    ids = tmp / "ids.txt"
    ids.write_text("rs1\nrs7 rs9\nrs12\n")
    recs = []
    for mod in (port_reader, jax_reader):
        v = mod.merge_vcfs([vcf], store_format=True)
        recs.append([r for c in v.contigs for r in v.records_for_contig(c)])
    return recs, str(ids)


@pytest.mark.parametrize("expr", EXPRS)
def test_compile_filter_equals_jax(panel_records, expr):
    (port_recs, jax_recs), ids = panel_records
    expr = expr.format(ids=ids)
    f, g = port_filter.compile_filter(expr), jax_filter.compile_filter(expr)
    got = [bool(f(r)) for r in port_recs]
    want = [bool(g(r)) for r in jax_recs]
    assert len(got) > 100
    assert got == want


BAD_EXPRS = ["TYPE +", 'TYPE>"snp"', "TYPE + 1 > 0", "STRLEN(QUAL) > 0",
             'ID~"["', "ID=@/nonexistent/ids.txt"]


@pytest.mark.parametrize("expr", BAD_EXPRS)
def test_compile_filter_errors_equal_jax(panel_records, expr):
    (port_recs, jax_recs), _ = panel_records
    msgs = []
    for mod, recs, err in ((port_filter, port_recs, PfbwtError),
                           (jax_filter, jax_recs, JaxPfbwtError)):
        with pytest.raises(err) as e:
            mod.compile_filter(expr)(recs[0])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


CASES = {
    "plain": ["-s", "s1", "-H", "1"],
    "ref_only": [],
    "markers": ["-s", "s0", "-H", "1", "-x", "{out}.mps"],
    "marker_windows": ["-s", "s2", "-H", "2", "-x", "{out}.mps", "-w", "3",
                       "-l", "8"],
    "marks": ["-s", "s1", "-H", "1", "--mark-snv", "lc", "--mark-ins", "uc",
              "--mark-del", "-", "-p", "px_"],
    "absent_missing": ["-s", "s0", "-H", "2", "-a", "N", "-M", "."],
    "mask": ["-s", "s1", "-H", "1", "-m", "{bed}"],
    "mask_lc": ["-s", "s1", "-H", "1", "-m", "{bed}", "--mask-with", "lc"],
    "hap2": ["-s", "s2", "-H", "2"],
    "include": ["-s", "s1", "-H", "1", "-i", 'TYPE="snp"'],
    "exclude": ["-s", "s1", "-H", "2", "-e", "QUAL<30 || FMT/DP>30"],
    "chain": ["-s", "s0", "-H", "1", "-c", "{out}.chain"],
    "chain_markers": ["-s", "s2", "-H", "1", "-c", "{out}.chain", "-x",
                      "{out}.mps", "-i", 'FILTER="PASS"'],
}


def _consensus(tmp_path, fa, vcf, name, main, args, capsysbinary):
    """Run one package's CLI on its own copy of the FASTA (the .fai is
    written beside it); returns (exit code, stdout, stderr) and the output
    prefix."""
    out = str(tmp_path / name)
    ref = f"{out}.ref.fa"
    shutil.copy(fa, ref)
    bed = tmp_path / "mask.bed"
    bed.write_text("seq0\t0\t40\nseq1\t100\t260\n")
    argv = [vcf, "-f", ref, *[a.format(out=out, bed=bed) for a in args]]
    capsysbinary.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    cap = capsysbinary.readouterr()
    return (rc, cap.out, cap.err), out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("to_file", [True, False])
def test_consensus_cli_equals_jax(tmp_path, capsysbinary, case, to_file):
    fa, vcf, _ = _panel(tmp_path)
    args = CASES[case] + (["-o", "{out}.fa"] if to_file else [])
    results = {}
    for name, main in (("port", consensus.main), ("jax", jax_consensus.main)):
        results[name] = _consensus(tmp_path, fa, vcf, name, main, args,
                                   capsysbinary)
    (got, port), (want, jax) = results["port"], results["jax"]
    assert got == want and got[0] == 0
    assert bool(got[1]) != to_file
    for ext in ("fa", "mps", "chain", "ref.fa.fai"):
        a, b = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        assert a.exists() == b.exists(), ext
        if b.exists():
            assert a.read_bytes() == b.read_bytes(), ext
    if "-x" in args:
        assert (tmp_path / "port.mps").stat().st_size > 0


ERRORS = {
    "include_and_exclude": ["-s", "s1", "-i", 'TYPE="snp"', "-e", "QUAL<3"],
    "length_change_with_markers": ["-s", "s1", "-x", "{out}.mps",
                                   "--mark-del", "-"],
    "absent_with_markers": ["-s", "s1", "-x", "{out}.mps", "-a", "N"],
    "bad_mark_ins": ["-s", "s1", "--mark-ins", "xx"],
    "bad_mark_snv": ["-s", "s1", "--mark-snv", "UC"],
    "no_fasta": None,
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_consensus_error_exits_equal_jax(tmp_path, capsysbinary, case):
    fa, vcf, _ = _panel(tmp_path, decorate=False)
    results = []
    for name, main in (("port", consensus.main), ("jax", jax_consensus.main)):
        if ERRORS[case] is None:
            capsysbinary.readouterr()
            with pytest.raises(SystemExit) as e:
                main([vcf, "-s", "s1"])
            cap = capsysbinary.readouterr()
            results.append((e.value.code, cap.out, cap.err))
            continue
        results.append(_consensus(tmp_path, fa, vcf, name, main,
                                  ERRORS[case] + ["-o", "{out}.fa"],
                                  capsysbinary)[0])
    assert results[0] == results[1]
    assert results[0][0] not in (0, None)


@pytest.mark.parametrize("sample,hap", [("s0", 1), ("s2", 2)])
def test_consensus_equals_vcf_scan(tmp_path, sample, hap):
    """consensus -s S -H h -x with vcf_scan's marker window (-w 1) writes
    vcf_scan -S S -H h-1 -m's FASTA and .mps (their defaults: -w 10 text
    bias in both)."""
    fa, vcf, _ = _panel(tmp_path, decorate=False)
    pre = str(tmp_path / "scan")
    assert vcf_scan.main(["-f", fa, "-o", pre, "-S", sample, "-H",
                          str(hap - 1), "-m", vcf]) == 0
    out = str(tmp_path / "cons")
    assert consensus.main([vcf, "-f", fa, "-s", sample, "-H", str(hap),
                           "-x", out + ".mps", "-w", "1",
                           "-o", out + ".fa"]) == 0
    for ext in ("fa", "mps"):
        assert (open(f"{pre}.{sample}.{hap - 1}.{ext}", "rb").read()
                == open(f"{out}.{ext}", "rb").read()), ext
