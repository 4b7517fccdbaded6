"""The port's CLI (``python -m pfbwtf_tpu_torch.cli.pfbwt_f``: the staged
build, ``--fused`` and ``--fused -m``; the staged ``-m`` is in
test_torch_mmap.py) writes the same bytes as the pfbwtf_tpu CLI."""

import numpy as np
import pytest

from pfbwtf_tpu.cli.pfbwt_f import main as jax_main
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main

ACGT = np.frombuffer(b"ACGT", np.uint8)
# the files of a staged -s -r run: stages 1 and 2, then stage 3
ELEVEN = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai", "bwt",
          "sa", "ssa", "esa")
# what pfbwtf_tpu's --device sets, with os.environ.setdefault
DEVICE_ENV = ("PFBWT_BACKEND", "PFBWT_DICT_IMPL", "PFBWT_ASSEMBLE_BACKEND",
              "PFBWT_MA_BACKEND")


def _device_env(monkeypatch):
    """Set pfbwtf_tpu's --device variables through monkeypatch, so that
    they end with the test instead of leaking into the worker's next
    tests (setdefault then finds them set)."""
    for var in DEVICE_ENV:
        monkeypatch.setenv(var, "jax")


def _fasta(path, seed=41, unit_len=1500, copies=3):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    with open(path, "wb") as f:
        for i in range(copies):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=15)
            hap[pos] = ACGT[rng.integers(0, 4, size=15)]
            # lower case and 'N' exercise the normalization
            hap[:40] = np.frombuffer(b"acgtn" * 8, np.uint8)
            f.write(b">hap%d descr\n" % i)
            for j in range(0, hap.size, 70):
                f.write(hap[j: j + 70].tobytes() + b"\n")


def _assert_files_equal(tmp_path, got, want, exts=ELEVEN):
    for ext in exts:
        a = (tmp_path / f"{got}.{ext}").read_bytes()
        b = (tmp_path / f"{want}.{ext}").read_bytes()
        assert len(b) > 0 and a == b, (got, want, ext)


@pytest.mark.parametrize("extra", [[], ["--u32"], ["-w", "6", "-p", "17"],
                                   ["--device"]])
def test_cli_fused_bytes_equal_jax(tmp_path, extra, monkeypatch):
    """--fused, and --fused --device, which runs the same build."""
    if "--device" in extra:
        _device_env(monkeypatch)
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["--fused", "-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    for ext in ("bwt", "sa", "ssa", "esa"):
        want = (tmp_path / f"jax.{ext}").read_bytes()
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert len(want) > 0 and got == want, ext
    width = 4 if "--u32" in extra else 8
    n1 = len((tmp_path / "port.bwt").read_bytes())
    assert len((tmp_path / "port.sa").read_bytes()) == n1 * width


@pytest.mark.parametrize("extra", [[], ["--u32"]])
def test_cli_fused_stream_bytes_equal_jax_and_fused(tmp_path, extra):
    """--fused -m -s -r: the same files as the JAX CLI's --fused -m and as
    the port's own --fused."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), "--fused", "-m",
                     *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), "--fused",
                       "-m", *args], device="cpu") == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "mono"), "--fused",
                       *args], device="cpu") == 0
    for ext in ("bwt", "sa", "ssa", "esa"):
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert len(got) > 0
        assert got == (tmp_path / f"jax.{ext}").read_bytes(), ext
        assert got == (tmp_path / f"mono.{ext}").read_bytes(), ext


@pytest.mark.parametrize("extra", [[], ["--device"], ["--u32"],
                                   ["--print-docs"], ["-w", "6", "-p", "17"],
                                   ["--trim-non-acgt"]])
def test_cli_staged_bytes_equal_jax(tmp_path, extra, monkeypatch):
    """The staged build (-s -r): all eleven files equal the pfbwtf_tpu
    CLI's (its host paths on the CPU, its device stages with --device),
    --print-docs adds .docs and --trim-non-acgt an empty .ntab."""
    if "--device" in extra:
        _device_env(monkeypatch)
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    exts = ELEVEN + (("docs",) if "--print-docs" in extra else ())
    _assert_files_equal(tmp_path, "port", "jax", exts)
    assert (tmp_path / "port.docs").exists() == ("--print-docs" in extra)
    if "--trim-non-acgt" in extra:
        assert (tmp_path / "port.ntab").read_bytes() == b""
    width = 4 if "--u32" in extra else 8
    assert len((tmp_path / "port.ilist").read_bytes()) % width == 0
    n1 = len((tmp_path / "port.bwt").read_bytes())
    assert len((tmp_path / "port.sa").read_bytes()) == n1 * width


@pytest.mark.parametrize("extra", [[], ["--u32"]])
def test_cli_staged_equals_jax_device(tmp_path, extra, monkeypatch):
    """pfbwtf_tpu --device (its JAX device stages) against the port's
    staged build, with and without --device."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", *extra]
    _device_env(monkeypatch)
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), "--device",
                     *args]) == 0
    for name, more in (("port", []), ("portdev", ["--device"])):
        assert torch_main([str(fa), "-o", str(tmp_path / name), *more,
                           *args], device="cpu") == 0
        _assert_files_equal(tmp_path, name, "jax")


def test_cli_chunk_mb_equals_jax_and_whole(tmp_path):
    """--chunk-mb 1 on an input of three chunks: the eleven files equal
    pfbwtf_tpu's --chunk-mb 1 and the port's whole-array staged build."""
    fa = tmp_path / "in.fa"
    _fasta(fa, seed=43, unit_len=700_000, copies=4)
    assert fa.stat().st_size > 2 << 20
    args = ["-s", "-r", "--print-docs"]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), "--chunk-mb", "1",
                     *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), "--chunk-mb",
                       "1", *args], device="cpu") == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "whole"), *args],
                      device="cpu") == 0
    _assert_files_equal(tmp_path, "port", "jax", ELEVEN + ("docs",))
    _assert_files_equal(tmp_path, "port", "whole", ELEVEN + ("docs",))


@pytest.mark.parametrize("extra", [[], ["--u32"]])
@pytest.mark.parametrize("parser", ["jax", "port"])
def test_cli_parse_only_then_pfbwt_only_across_packages(tmp_path, parser,
                                                        extra):
    """--parse-only by one package, --pfbwt-only by the other, from the
    same checkpoint files: the final files equal a whole JAX run."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "want"), *args]) == 0
    ck = str(tmp_path / "ck")

    def port(a):
        return torch_main(a, device="cpu")

    first, second = (jax_main, port) if parser == "jax" else (port, jax_main)
    assert first([str(fa), "-o", ck, "--parse-only", *args]) == 0
    assert not (tmp_path / "ck.bwt").exists()
    _assert_files_equal(tmp_path, "ck", "want", ELEVEN[:7])
    assert second(["-o", ck, "--pfbwt-only", *args]) == 0
    _assert_files_equal(tmp_path, "ck", "want")


@pytest.mark.parametrize("args", [
    ["-s", "-r", "--shards", "1"], ["-s", "-r", "--workers", "2"],
    ["--fused", "-s", "--shards", "1"],
])
def test_cli_lone_shards_and_workers_equal_jax(tmp_path, args):
    """--shards 1 and a --workers count without --shards > 1 change
    nothing in pfbwtf_tpu's CLI (its pod parse runs only for --shards > 1,
    and --fused reads neither): the same exit code and files."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    rc = jax_main([str(fa), "-o", str(tmp_path / "jax"), *args])
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == rc == 0
    exts = ("bwt", "sa") if "--fused" in args else ELEVEN
    _assert_files_equal(tmp_path, "port", "jax", exts)


def _files_of(tmp_path, prefix):
    """{name after the prefix: bytes} of every file a run wrote."""
    return {p.name[len(prefix):]: p.read_bytes()
            for p in tmp_path.iterdir() if p.name.startswith(prefix + ".")}


@pytest.mark.parametrize("args", [
    ["--fused", "-s", "--parse-only"], ["--fused", "-s", "--pfbwt-only"],
    ["--fused", "-s", "-r", "--print-docs"], ["-s", "--shards", "2"],
    ["--fused", "-s", "--chunk-mb", "4"], ["--fused", "-r", "--shards", "2"],
    ["--fused", "-s", "--workers", "2"],
    ["--fused", "--parse-only", "--pfbwt-only"],
])
def test_cli_formerly_refused_modes_equal_jax(tmp_path, args, monkeypatch):
    """--fused ignores the staged build's flags, as pfbwtf_tpu's CLI does
    (--parse-only with --pfbwt-only still exits 1 first), and --shards 2
    runs the pod parse: the same exit code and the same files, checkpoint
    and shard files included."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    rc = torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                    device="cpu")
    # pfbwtf_tpu's in-process shard worker sets PFBWT_BACKEND with
    # setdefault: set it here, so that it ends with the test
    monkeypatch.setenv("PFBWT_BACKEND", "numpy")
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == rc
    got, want = _files_of(tmp_path, "port"), _files_of(tmp_path, "jax")
    assert got == want
    if rc == 0:
        assert ".bwt" in got
    if "--fused" in args and rc == 0:
        assert ".dict" not in got


@pytest.mark.parametrize("args", [
    ["--mesh"], ["--fused", "-m", "--mesh"], ["--fused", "--mesh"],
])
def test_cli_unported_modes_exit_1(tmp_path, args, capsys):
    """The modes that exited 1 before the mesh family was ported
    (--mesh, --fused -m --mesh, --fused --mesh) now run, in process as a
    one-rank gloo world, and write the files and exit code of
    pfbwtf_tpu's CLI on its 8-device CPU mesh; the world is gone after
    the call."""
    import torch.distributed as dist

    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = [*args, "-s", "-r"]
    rc = torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                    device="cpu")
    assert not dist.is_initialized()
    assert "not ported" not in capsys.readouterr().err
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == rc == 0
    got, want = _files_of(tmp_path, "port"), _files_of(tmp_path, "jax")
    assert got == want and ".bwt" in got and ".ssa" in got
    assert (".dict" in got) == ("--fused" not in args)


def test_cli_invalid_char_exits_1(tmp_path, capsys):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">x\nACGTBACGTACGTACGTACGT\n")
    rc = torch_main([str(fa), "-o", str(tmp_path / "o"), "--fused", "-p",
                     "3"], device="cpu")
    assert rc == 1
    assert "invalid character" in capsys.readouterr().err
