"""The port's import boundary: pfbwtf_tpu_torch (every module, those of
the staged build and the gather probe included) and chip_smoke.py import
neither jax, nor pfbwtf_tpu, nor the TPU probes under benchmarks/, and
the entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pfbwtf_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_import_loads_no_jax_in_a_fresh_interpreter():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pfbwtf_tpu_torch\n"
        "for m in pkgutil.walk_packages(pfbwtf_tpu_torch.__path__,"
        " 'pfbwtf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'pfbwtf_tpu', 'benchmarks')]\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pfbwtf_tpu", "benchmarks"), (
                path, name)


NEW_MODULES = (
    "engine", "pipeline", "native", "ops.chunked", "ops.gather",
    "ops.cuda.gather", "parallel.dict_union", "probes.gather_probe",
    "ops.suffix_np", "ops.bwt_mmap", "markers.ma", "markers.ma_dev",
    "markers.mps", "vcf.reader", "vcf.scan", "vcf.scan_worker",
    "vcf.pipeline", "cli.vcf_to_bwt", "cli.vcf_scan", "cli.merge_mps",
    "cli.mps_to_ma", "parallel.merge", "vcf.filter", "markers.dump",
    "ops.bwt", "ops.parse_bwt", "cli.merge_pfp", "cli.simplebwt",
    "cli.consensus", "cli.dump_markers", "cli.readable_sa",
    "cli.readable_markers", "cli.dump_intfile", "parallel.driver",
    "utils.malloc_tuning", "parallel.sharded", "parallel.dsort",
    "parallel.pfbwt_mesh", "parallel.fused_mesh", "parallel.multihost",
)


@pytest.mark.parametrize("name", NEW_MODULES)
def test_staged_and_probe_modules_are_checked(name):
    """The AST check above covers the modules of the staged build, the
    probe, vcf_to_bwt, the merge, the host assembly, the host tools and
    the mesh family (it walks the package)."""
    path = os.path.join(PKG, *name.split(".")) + ".py"
    assert path in list(_port_sources())


def test_parallel_import_makes_no_process_group():
    """Importing the mesh family (and every module of the port) makes no
    torch.distributed world; only a mesh call does."""
    code = (
        "import importlib, pkgutil\n"
        "import torch.distributed as dist\n"
        "import pfbwtf_tpu_torch, pfbwtf_tpu_torch.parallel\n"
        "for m in pkgutil.walk_packages(pfbwtf_tpu_torch.__path__,"
        " 'pfbwtf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert dist.is_available() and not dist.is_initialized()\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_mesh_default_device_raises_without_a_card():
    """make_parse_mesh takes the card unless asked for the CPU, and makes
    no world when it cannot."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import torch.distributed as dist

    from pfbwtf_tpu_torch.parallel.sharded import make_parse_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_parse_mesh()
    assert not dist.is_initialized()
    with make_parse_mesh("cpu") as mesh:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_device
    from pfbwtf_tpu_torch.utils.device import resolve_device

    C = np.frombuffer(b"ACGTTGCA" * 100, np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfbwt_fused_device(C, 4, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from pfbwtf_tpu_torch.cli.pfbwt_f import main

    fa = tmp_path / "x.fa"
    fa.write_bytes(b">x\n" + b"ACGTTGCAAC" * 100 + b"\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(fa), "-o", str(tmp_path / "o"), "--fused", "-s"])


def test_merge_pfp_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from pfbwtf_tpu_torch.cli.merge_pfp import main

    fa = tmp_path / "x.fa"
    fa.write_bytes(b">x\n" + b"ACGTTGCAAC" * 100 + b"\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(fa), str(fa), "-o", str(tmp_path / "o"), "-s",
              "--parse-bwt"])


@pytest.mark.parametrize("extra", [[], ["--chunk-mb", "1"],
                                   ["--shards", "2", "--workers", "1"]])
def test_staged_cli_default_device_raises_without_a_card(tmp_path, extra):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from pfbwtf_tpu_torch.cli.pfbwt_f import main

    fa = tmp_path / "x.fa"
    fa.write_bytes(b">x\n" + b"ACGTTGCAAC" * 100 + b"\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(fa), "-o", str(tmp_path / "o"), "-s", *extra])


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    from pfbwtf_tpu_torch.ops.cuda import build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    assert build.sources() == ["carry_scan", "gather", "hash_scan"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library_path("hash_scan")


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_import_tunes_no_malloc_the_build_clis_do(tmp_path, monkeypatch,
                                                 capsys):
    """Importing every module of the port leaves glibc's malloc alone
    (pfbwtf_tpu tunes it at import); the build CLIs tune it first thing,
    and so does each of the pod parse's shard parses."""
    code = (
        "import importlib, pkgutil\n"
        "import pfbwtf_tpu_torch\n"
        "from pfbwtf_tpu_torch.utils import malloc_tuning\n"
        "real, calls = malloc_tuning.tune_malloc, []\n"
        "malloc_tuning.tune_malloc = lambda *a: calls.append(a)\n"
        "for m in pkgutil.walk_packages(pfbwtf_tpu_torch.__path__,"
        " 'pfbwtf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert calls == [], calls\n"
        "assert real()\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout

    from pfbwtf_tpu_torch.cli import merge_pfp, pfbwt_f, vcf_to_bwt
    from pfbwtf_tpu_torch.utils import malloc_tuning

    calls = []
    for mod in (pfbwt_f, merge_pfp, vcf_to_bwt):
        monkeypatch.setattr(mod, "tune_malloc", lambda: calls.append(1))
    monkeypatch.setattr(malloc_tuning, "tune_malloc",
                        lambda: calls.append(2))
    rng = np.random.default_rng(3)
    fa = tmp_path / "x.fa"
    fa.write_bytes(b"".join(
        b">%d\n" % i + rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  size=3000).tobytes() + b"\n"
        for i in range(2)))
    assert pfbwt_f.main([str(fa), "-o", str(tmp_path / "o"), "-s",
                         "--shards", "2", "--workers", "1"],
                        device="cpu") == 0
    assert calls == [1, 2, 2]  # the CLI, then each in-process shard
    assert merge_pfp.main([str(fa), "-o", str(tmp_path / "m")],
                          device="cpu") == 0
    # exit 1 from the missing panel (the mesh's rank 0 reads it first)
    assert vcf_to_bwt.main(["--mesh", str(fa), str(tmp_path / "v.vcf"),
                            "-o", str(tmp_path / "v")], device="cpu") == 1
    assert "v.vcf" in capsys.readouterr().err
    assert calls == [1, 2, 2, 1, 1]
