"""The port's --mesh CLIs in a 2-rank gloo world, every rank running the
CLI as under torchrun: ``pfbwt_f --mesh`` (staged), ``--fused --mesh``
and ``vcf_to_bwt --mesh`` write, from rank 0 alone, the files of
pfbwtf_tpu's CLIs on its 8-device CPU mesh, and every rank returns 0; an
invalid character and a p so large that the parse has one word make
every rank return 1, as pfbwtf_tpu's CLI does, and no rank hangs.  Under
torchrun's variables alone (no process group made beforehand),
``make_parse_mesh`` and the CLI join the launcher's 2-rank world."""

import os
import shutil

import numpy as np
import pytest

from tests.torch_worlds import free_ports, run_launched, run_world

SIZE = 2
ACGT = np.frombuffer(b"ACGT", np.uint8)
RUNS = {
    "staged": ["--mesh", "-s", "-r"],
    "fused": ["--fused", "--mesh", "-s", "-r"],
    "fused_m": ["--fused", "-m", "--mesh", "-s", "-r", "--u32"],
}
ERRORS = {
    "invalid_char": ("bad.fa", ["--mesh", "-s"]),
    "invalid_char_fused": ("bad.fa", ["--fused", "--mesh", "-s"]),
    "one_word": ("in.fa", ["--mesh", "-s", "-p", str(1 << 40)]),
    "one_word_fused": ("in.fa", ["--fused", "--mesh", "-p", str(1 << 40)]),
}
VCF_ARGS = ["--mesh", "-s", "-r", "-m"]


def _inputs(d):
    rng = np.random.default_rng(41)
    unit = rng.choice(ACGT, size=1500)
    with open(d / "in.fa", "wb") as f:
        for i in range(3):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=15)
            hap[pos] = ACGT[rng.integers(0, 4, size=15)]
            f.write(b">hap%d\n" % i + hap.tobytes() + b"\n")
    (d / "bad.fa").write_bytes(b">x\nACGTBACGTACGTACGTACGT\n" * 3)

    from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes

    from .ref_fixtures import random_fasta
    from .vcf_gen import random_vcf

    fa = random_fasta(str(d / "ref.fa"), rng, nrecords=2, length=1800)
    random_vcf(str(d / "p.vcf"), read_fasta_bytes(fa), rng, nsamples=3,
               density=0.02, indel_frac=0.3)
    for name in ("jax", "port"):
        shutil.copy(fa, d / f"{name}_ref.fa")  # the .fai goes beside it


def _world_cases(mesh, d):
    from pfbwtf_tpu_torch.cli import pfbwt_f, vcf_to_bwt

    rc = {}
    for name, args in RUNS.items():
        rc[name] = pfbwt_f.main([os.path.join(d, "in.fa"), "-o",
                                 os.path.join(d, f"port_{name}"), *args],
                                device="cpu")
    rc["vcf"] = vcf_to_bwt.main(
        [os.path.join(d, "port_ref.fa"), os.path.join(d, "p.vcf"), "-o",
         os.path.join(d, "port_vcf"), *VCF_ARGS], device="cpu")
    for name, (fa, args) in ERRORS.items():
        rc[name] = pfbwt_f.main([os.path.join(d, fa), "-o",
                                 os.path.join(d, f"port_{name}"), *args],
                                device="cpu")
    return rc


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    _inputs(d)
    return d, run_world(SIZE, _world_cases, d / "world", args=(str(d),))


def _files_of(d, prefix):
    return {p.name[len(prefix):]: p.read_bytes()
            for p in d.iterdir() if p.name.startswith(prefix + ".")}


@pytest.mark.parametrize("name", list(RUNS))
def test_pfbwt_f_mesh_in_a_world_equals_jax(world, name):
    from pfbwtf_tpu.cli.pfbwt_f import main as jax_main

    d, ranks = world
    assert [r[name] for r in ranks] == [0] * SIZE
    assert jax_main([str(d / "in.fa"), "-o", str(d / f"jax_{name}"),
                     *RUNS[name]]) == 0
    got = _files_of(d, f"port_{name}")
    assert got == _files_of(d, f"jax_{name}") and ".bwt" in got


def test_vcf_to_bwt_mesh_in_a_world_equals_jax(world):
    from pfbwtf_tpu.cli.vcf_to_bwt import main as jax_main

    d, ranks = world
    assert [r["vcf"] for r in ranks] == [0] * SIZE
    assert jax_main([str(d / "jax_ref.fa"), str(d / "p.vcf"), "-o",
                     str(d / "jax_vcf"), *VCF_ARGS]) == 0
    exts = (".bwt", ".sa", ".ssa", ".esa", ".ma", ".mps")
    got, want = _files_of(d, "port_vcf"), _files_of(d, "jax_vcf")
    for ext in exts:
        assert got[ext] == want[ext], ext


@pytest.mark.parametrize("name", list(ERRORS))
def test_mesh_errors_exit_1_on_every_rank(world, name):
    from pfbwtf_tpu.cli.pfbwt_f import main as jax_main

    d, ranks = world
    assert [r[name] for r in ranks] == [1] * SIZE
    fa, args = ERRORS[name]
    assert jax_main([str(d / fa), "-o", str(d / f"jax_{name}"), *args]) == 1
    assert _files_of(d, f"port_{name}") == _files_of(d, f"jax_{name}")


def _launched_cases(d, cli_port):
    """Under torchrun's variables: make_parse_mesh's world, then the
    fused mesh CLI's, each joined through them and destroyed after."""
    import torch.distributed as dist

    from pfbwtf_tpu_torch.cli import pfbwt_f
    from pfbwtf_tpu_torch.parallel.sharded import make_parse_mesh

    with make_parse_mesh("cpu") as mesh:
        seen = (mesh.rank, mesh.size, mesh.owned)
    left = dist.is_initialized()
    rank = os.environ["RANK"]
    os.environ["MASTER_PORT"] = str(cli_port)
    rc = pfbwt_f.main([os.path.join(d, "in.fa"), "-o",
                       os.path.join(d, f"port_launched{rank}"),
                       *RUNS["fused"]], device="cpu")
    return seen, left, rc, dist.is_initialized()


def test_mesh_under_a_launcher_joins_its_world(world, tmp_path):
    """Each process sees rank r of 2 in a world it owns and destroys;
    through the CLI only rank 0 writes (to its own prefix), and its
    files are pfbwtf_tpu's."""
    from pfbwtf_tpu.cli.pfbwt_f import main as jax_main

    d, _ = world
    ranks = run_launched(SIZE, _launched_cases, tmp_path / "world",
                         args=(str(d), free_ports(1)[0]))
    assert [r[0] for r in ranks] == [(r, SIZE, True) for r in range(SIZE)]
    assert [r[1:] for r in ranks] == [(False, 0, False)] * SIZE
    assert _files_of(d, "port_launched1") == {}
    assert jax_main([str(d / "in.fa"), "-o", str(d / "jax_launched"),
                     *RUNS["fused"]]) == 0
    got = _files_of(d, "port_launched0")
    assert got == _files_of(d, "jax_launched") and ".bwt" in got
